"""Vectorized stackless BVH traversal: the hottest code path.

The reference walks the BVH with one CUDA thread per ray and an
explicit per-thread stack (reference: chroma/cuda/mesh.h:41).  A
per-ray stack is poison for a whole-array program — the (N, depth)
scatter per step dominated everything in profiling — so this walker
traverses with precomputed *escape pointers* ("ropes",
chroma_jax/ops/geometry_pack.py compute_escape_pointers): every node
knows where a depth-first walk goes when the node is skipped or
finished.  Per-ray state collapses to one node cursor + the best hit,
and each lock-step iteration is two gathers (packed node, escape)
plus one pre-assembled triangle gather on leaf steps, with all
arithmetic fused by XLA.

Rays that finish idle until their wave completes, so callers process
photons in waves (``chunked``) and keep rays coherent (Morton order)
where possible.
"""
from functools import partial

import jax
import jax.numpy as jnp

from chroma_jax.ops.intersect import intersect_box, intersect_triangle

CHILD_BITS = 28
CHILD_MASK = jnp.uint32(0x0FFFFFFF)
SENTINEL = jnp.uint32(0xFFFFFFFF)


def _dequantize(packed_xyz, world_origin, world_scale):
    """Unpack (N,3) uint32 (lo | hi<<16) into world-space AABB corners
    (reference: chroma/cuda/geometry.h get_node)."""
    lower = (packed_xyz & jnp.uint32(0xFFFF)).astype(jnp.float32)
    upper = (packed_xyz >> jnp.uint32(16)).astype(jnp.float32)
    return (world_origin + lower * world_scale,
            world_origin + upper * world_scale)


@partial(jax.jit, static_argnames=('max_iters',))
def intersect_mesh(origin, direction, geom, last_hit_triangle=None,
                   max_iters=262144):
    """Closest-hit mesh intersection for a batch of rays.

    Args:
      origin, direction: (N,3) f32; direction must be normalized.
      geom: GeometryTables.
      last_hit_triangle: (N,) i32 triangle to skip (a ray may not hit
        the same triangle twice in a row; reference: chroma/cuda/mesh.h:82),
        or None.

    Returns (triangle_index (N,) i32 with -1 = miss,
             distance (N,) f32, inf on miss).
    """
    n = origin.shape[0]
    if last_hit_triangle is None:
        last_hit_triangle = jnp.full(n, -1, jnp.int32)

    inv_dir = 1.0 / direction
    neg_origin_inv_dir = -origin * inv_dir

    nodes = geom.nodes
    escape = geom.escape
    n_nodes = nodes.shape[0]

    state = dict(
        cur=jnp.zeros(n, jnp.uint32),
        best_tri=jnp.full(n, -1, jnp.int32),
        min_dist=jnp.full(n, jnp.inf, jnp.float32),
        iters=jnp.zeros((), jnp.int32),
    )

    def cond(s):
        return jnp.any(s['cur'] != SENTINEL) & (s['iters'] < max_iters)

    def body(s):
        active = s['cur'] != SENTINEL
        node_idx = jnp.where(active, s['cur'], 0)
        node_idx = jnp.minimum(node_idx, jnp.uint32(n_nodes - 1))
        packed = nodes[node_idx]                       # (N,4) gather
        esc = escape[node_idx]                         # (N,)  gather
        lower, upper = _dequantize(packed[:, :3],
                                   geom.legacy_world_origin,
                                   geom.legacy_world_scale)
        box_hit, box_dist = intersect_box(neg_origin_inv_dir, inv_dir,
                                          lower, upper)
        hit = active & box_hit & (box_dist <= s['min_dist'])

        w = packed[:, 3]
        nchild = w >> jnp.uint32(CHILD_BITS)
        child = w & CHILD_MASK
        is_leaf = nchild == 0

        # ---- leaf: test the wrapped (pre-assembled) triangle ----------
        do_tri = hit & is_leaf & (child.astype(jnp.int32)
                                  != last_hit_triangle)
        tri_idx = jnp.where(do_tri, child, 0)
        tv = geom.tri_vertices[tri_idx]                # (N,3,3) gather
        t_hit, t_dist = intersect_triangle(origin, direction,
                                           tv[:, 0], tv[:, 1], tv[:, 2])
        better = do_tri & t_hit & (t_dist < s['min_dist'])
        best_tri = jnp.where(better, child.astype(jnp.int32), s['best_tri'])
        min_dist = jnp.where(better, t_dist, s['min_dist'])

        # ---- descend into hit internal nodes, else follow the rope ----
        descend = hit & ~is_leaf
        cur = jnp.where(active, jnp.where(descend, child, esc), SENTINEL)

        return dict(cur=cur, best_tri=best_tri, min_dist=min_dist,
                    iters=s['iters'] + 1)

    out = jax.lax.while_loop(cond, body, state)
    return out['best_tri'], out['min_dist']


def chunked(fn, wave=131072):
    """Split a batched op into fixed-size waves with lax.map so slow
    rays only stall their own wave and loop state stays small."""
    def wrapper(*arrays):
        n = arrays[0].shape[0]
        pad = -n % wave
        padded = [jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:],
                                                a.dtype)]) if pad else a
                  for a in arrays]
        stacked = [a.reshape(-1, wave, *a.shape[1:]) for a in padded]
        res = jax.lax.map(lambda xs: fn(*xs), tuple(stacked))
        return jax.tree_util.tree_map(
            lambda r: r.reshape(-1, *r.shape[2:])[:n], res)
    return wrapper


@partial(jax.jit, static_argnames=('wave',))
def distance_to_mesh(origin, direction, geom, wave=131072):
    """Distance from each ray origin to the mesh, inf on miss
    (reference: chroma/cuda/mesh.h distance_to_mesh kernel)."""
    direction = direction / jnp.linalg.norm(direction, axis=-1,
                                            keepdims=True)
    if origin.shape[0] <= wave:
        return intersect_mesh(origin, direction, geom)
    return chunked(lambda o, d: intersect_mesh(o, d, geom),
                   wave)(origin, direction)
