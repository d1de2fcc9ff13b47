"""Alpha-depth geometry rendering (reference: chroma/cuda/render.cu +
chroma/gpu/render.py).

The reference collects the alpha_depth nearest hits per ray inside one
traversal with a per-thread sorted insertion list; here we peel depth
layers instead: each pass finds the closest hit with the MBVH walker,
shades it (cosine shading, reference render.cu get_color), composites
front-to-back, and advances the ray origin just past the hit.  Camera
rays are coherent, which is exactly the traversal's fast path.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax.ops import mbvh
from chroma_jax.ops.intersect import normalize, dot
from chroma_jax.transform import make_rotation_matrix


def _rotate(v, rot):
    """Row vectors ``v`` rotated by ``rot``, in full float32: a float32
    matmul on the GPU may otherwise run in TF32 (about three decimal
    digits), which would smear the rays of a rotated camera."""
    return jnp.matmul(v, rot.T, precision=jax.lax.Precision.HIGHEST)


@partial(jax.jit, static_argnames=('alpha_depth',))
def render(origin, direction, geom, alpha_depth=10, bg_color=0x66666666):
    """Render rays against the geometry; returns (N,) uint32 ARGB pixels."""
    n = origin.shape[0]
    direction = direction / jnp.linalg.norm(direction, axis=-1,
                                            keepdims=True)

    def shade(res):
        """Cosine-shaded RGB + alpha from hit color (render.cu:12)."""
        hit = res['triangle'] >= 0
        rgba = geom.colors[jnp.maximum(res['triangle'], 0)]
        # guard the zero normal of missed rays (0/0 -> NaN would poison
        # the accumulator through 0 * NaN)
        normal = res['normal'] + jnp.where(hit, 0.0, 1.0)[:, None]
        normal = normalize(normal)
        cos_theta = jnp.abs(dot(normal, -direction))
        a0 = (rgba >> jnp.uint32(24)) & jnp.uint32(0xFF)
        r0 = ((rgba >> jnp.uint32(16)) & jnp.uint32(0xFF)).astype(jnp.float32)
        g0 = ((rgba >> jnp.uint32(8)) & jnp.uint32(0xFF)).astype(jnp.float32)
        b0 = (rgba & jnp.uint32(0xFF)).astype(jnp.float32)
        alpha = (255 - a0).astype(jnp.float32) / 255.0
        return (jnp.stack([r0, g0, b0], axis=-1) * cos_theta[:, None],
                alpha)

    def body(carry, _):
        pos, transmit, rgb_acc = carry
        res = mbvh.intersect_mesh(pos, direction, geom)
        hit = res['triangle'] >= 0
        rgb, alpha = shade(res)
        contrib = jnp.where(hit, transmit * alpha, 0.0)
        rgb_acc = rgb_acc + contrib[:, None] * rgb
        transmit = jnp.where(hit, transmit * (1.0 - alpha), transmit)
        # step past the hit for the next depth layer
        pos = pos + jnp.where(hit, res['distance'] + 1e-3, 0.0)[:, None] \
            * direction
        return (pos, transmit, rgb_acc), hit

    (pos, transmit, rgb_acc), hits = jax.lax.scan(
        body, (origin, jnp.ones(n, jnp.float32),
               jnp.zeros((n, 3), jnp.float32)),
        None, length=alpha_depth)

    any_hit = jnp.any(hits, axis=0)
    # blend remaining transmission with the background
    bg = jnp.asarray([(bg_color >> 16) & 0xFF, (bg_color >> 8) & 0xFF,
                      bg_color & 0xFF], jnp.float32)
    rgb = rgb_acc + transmit[:, None] * bg[None, :]
    rgb = jnp.where(any_hit[:, None], rgb, bg[None, :])
    rgb = jnp.clip(rgb, 0, 255).astype(jnp.uint32)
    return (jnp.uint32(0xFF000000) | (rgb[:, 0] << jnp.uint32(16))
            | (rgb[:, 1] << jnp.uint32(8)) | rgb[:, 2])


class GPURays(object):
    """Camera ray buffers + transforms (reference: chroma/gpu/render.py
    GPURays; the CUDA transform kernels become jnp expressions)."""

    def __init__(self, pos, dir, max_alpha_depth=10, nblocks=None):
        self.pos = jnp.asarray(pos, jnp.float32)
        self.dir = jnp.asarray(dir, jnp.float32)
        self.max_alpha_depth = max_alpha_depth

    def rotate(self, phi, n):
        rot = jnp.asarray(make_rotation_matrix(phi, n), jnp.float32)
        self.pos = _rotate(self.pos, rot)
        self.dir = _rotate(self.dir, rot)

    def rotate_around_point(self, phi, n, point):
        rot = jnp.asarray(make_rotation_matrix(phi, n), jnp.float32)
        point = jnp.asarray(point, jnp.float32)
        self.pos = _rotate(self.pos - point, rot) + point
        self.dir = _rotate(self.dir, rot)

    def translate(self, v):
        self.pos = self.pos + jnp.asarray(v, jnp.float32)

    def render(self, gpu_geometry, pixels=None, alpha_depth=10,
               keep_last_render=False):
        """Returns (N,) uint32 ARGB pixel values."""
        return render(self.pos, self.dir, gpu_geometry.geom,
                      alpha_depth=alpha_depth)

    def snapshot(self, gpu_geometry, alpha_depth=10):
        return np.asarray(self.render(gpu_geometry,
                                      alpha_depth=alpha_depth))
