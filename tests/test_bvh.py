"""BVH structure + builder tests (model: reference test/test_bvh.py —
hand-packed trees, WorldCoords round trips, layer areas — plus builder
validity checks the reference lacked)."""
import numpy as np
import pytest

from chroma_jax import make
from chroma_jax.bvh import (BVH, WorldCoords, OutOfRangeError, CHILD_BITS,
                            unpack_nodes, node_areas, to_uint4, from_uint4,
                            make_recursive_grid_bvh, make_simple_bvh,
                            create_leaf_nodes)


def build_manual_bvh():
    """3-layer binary tree packed by hand."""
    x = np.uint32
    nodes = np.zeros((7, 4), dtype=np.uint32)

    def pack(i, lo, hi, child, nchild):
        nodes[i, 0] = lo[0] | (hi[0] << 16)
        nodes[i, 1] = lo[1] | (hi[1] << 16)
        nodes[i, 2] = lo[2] | (hi[2] << 16)
        nodes[i, 3] = child | (nchild << CHILD_BITS)

    pack(0, (0, 0, 0), (10, 10, 10), 1, 2)   # root
    pack(1, (0, 0, 0), (5, 10, 10), 3, 2)
    pack(2, (5, 0, 0), (10, 10, 10), 5, 2)
    pack(3, (0, 0, 0), (5, 5, 10), 17, 0)    # leaves: triangle ids
    pack(4, (0, 5, 0), (5, 10, 10), 18, 0)
    pack(5, (5, 0, 0), (10, 5, 10), 19, 0)
    pack(6, (5, 5, 0), (10, 10, 10), 20, 0)
    coords = WorldCoords(world_origin=(-1, -1, -1), world_scale=0.1)
    return BVH(coords, to_uint4(nodes), [0, 1, 3])


def test_unpack_nodes():
    bvh = build_manual_bvh()
    info = unpack_nodes(bvh.nodes)
    assert info['child'][0] == 1 and info['nchild'][0] == 2
    assert info['nchild'][3] == 0 and info['child'][3] == 17
    assert info['xhi'][2] == 10 and info['xlo'][2] == 5


def test_layers():
    bvh = build_manual_bvh()
    assert bvh.layer_count() == 3
    assert len(bvh.get_layer(0)) == 1
    assert len(bvh.get_layer(1)) == 2
    assert len(bvh.get_layer(2)) == 4
    root_area = bvh.get_layer(0).area_fixed()
    assert root_area == 2 * 3 * (10 * 10)


def test_world_coords_round_trip():
    coords = WorldCoords(world_origin=(-5.0, -5.0, -5.0), world_scale=0.01)
    world = np.array([[-5.0, 0.0, 5.0], [1.234, -4.567, 0.0]])
    fixed = coords.world_to_fixed(world)
    back = coords.fixed_to_world(fixed)
    assert np.abs(back - world).max() <= 0.01 / 2 + 1e-6
    with pytest.raises(OutOfRangeError):
        coords.world_to_fixed([1000.0, 0, 0])


def check_bvh_valid(bvh, mesh):
    """Every triangle appears in exactly one *reachable* leaf; every
    parent AABB contains its children; leaf AABBs contain their
    triangles.  (collapse_chains leaves unreachable orphan nodes behind,
    exactly like the reference builder.)"""
    arr = from_uint4(bvh.nodes)
    info = unpack_nodes(bvh.nodes)
    real = arr.any(axis=1)  # padding nodes are all-zero
    lo = np.stack([info['xlo'], info['ylo'], info['zlo']], axis=1).astype(int)
    hi = np.stack([info['xhi'], info['yhi'], info['zhi']], axis=1).astype(int)

    tri_ids, leaf_idx = [], []
    stack = [0]
    while stack:
        i = stack.pop()
        c0, nc = int(info['child'][i]), int(info['nchild'][i])
        if nc == 0:
            tri_ids.append(c0)
            leaf_idx.append(i)
            continue
        for c in range(c0, c0 + nc):
            if not real[c]:
                continue
            stack.append(c)
            assert (lo[i] <= lo[c]).all()
            assert (hi[i] >= hi[c]).all()
    assert sorted(tri_ids) == list(range(len(mesh.triangles)))
    leaf_idx = np.asarray(leaf_idx)

    # leaf AABBs contain their triangles (in world space)
    wc = bvh.world_coords
    tv = mesh.vertices[mesh.triangles[info['child'][leaf_idx]]]
    leaf_lo = wc.fixed_to_world(lo[leaf_idx])[:, None, :]
    leaf_hi = wc.fixed_to_world(hi[leaf_idx])[:, None, :]
    eps = wc.world_scale * 1e-3 + 1e-5
    assert (tv >= leaf_lo - eps).all()
    assert (tv <= leaf_hi + eps).all()


@pytest.mark.parametrize('builder,kwargs', [
    (make_recursive_grid_bvh, dict(target_degree=3)),
    (make_simple_bvh, dict(degree=2)),
    (make_simple_bvh, dict(degree=3)),
    (make_simple_bvh, dict(degree=4)),
])
def test_builders_valid(builder, kwargs):
    mesh = make.sphere(100.0, nsteps=16)
    bvh = builder(mesh, **kwargs)
    check_bvh_valid(bvh, mesh)
    # root layer must bound the whole mesh
    lower, upper = bvh.get_layer(0).get_bounds()
    mlow, mhigh = mesh.get_bounds()
    assert (lower[0] <= mlow + 1e-3).all()
    assert (upper[0] >= mhigh - 1e-3).all()


def test_layer_areas_decrease():
    mesh = make.cube(100.0)
    bvh = make_recursive_grid_bvh(mesh, target_degree=3)
    areas = [bvh.get_layer(i).area_fixed()
             for i in range(bvh.layer_count())]
    assert areas[0] <= areas[-1]


def test_leaf_quantization_conservative():
    mesh = make.cube(1.0)
    coords, nodes, morton = create_leaf_nodes(mesh)
    info = unpack_nodes(nodes)
    tv = mesh.vertices[mesh.triangles]
    lo = coords.fixed_to_world(
        np.stack([info['xlo'], info['ylo'], info['zlo']], 1).astype(float))
    hi = coords.fixed_to_world(
        np.stack([info['xhi'], info['yhi'], info['zhi']], 1).astype(float))
    assert (tv >= lo[:, None, :] - 1e-6).all()
    assert (tv <= hi[:, None, :] + 1e-6).all()


def test_optimize_layer_reduces_pair_area():
    """Greedy sibling pairing lowers the summed pair-union area
    (reference gpu/bvh.py:269 behavior)."""
    from chroma_jax.bvh.optimize import optimize_layer, \
        _pair_area_matrix
    from chroma_jax.bvh.bvh import unpack_nodes
    from chroma_jax.bvh.build import create_leaf_nodes
    from chroma_jax import make

    mesh = make.sphere(1.0, nsteps=12)
    _, leaves, _ = create_leaf_nodes(mesh)
    rng = np.random.RandomState(0)
    shuffled = leaves[rng.permutation(len(leaves))]

    def paired_area(nodes):
        info = unpack_nodes(nodes)
        lo = np.column_stack([info['xlo'], info['ylo'],
                              info['zlo']]).astype(float)
        hi = np.column_stack([info['xhi'], info['yhi'],
                              info['zhi']]).astype(float)
        m = (len(nodes) // 2) * 2
        return sum(_pair_area_matrix(lo[i:i + 1], hi[i:i + 1],
                                     lo[i + 1:i + 2],
                                     hi[i + 1:i + 2])[0, 0]
                   for i in range(0, m, 2))

    before = paired_area(shuffled)
    optimized, perm = optimize_layer(shuffled)
    after = paired_area(optimized)
    assert after < 0.7 * before
    # permutation, not mutation: same nodes survive
    assert sorted(map(tuple, optimized.tolist())) \
        == sorted(map(tuple, shuffled.tolist()))


def test_area_sort_children_preserves_intersections():
    """Child reordering must not change what rays hit."""
    import jax.numpy as jnp
    from chroma_jax.bvh.optimize import area_sort_children
    from chroma_jax import make
    from chroma_jax.geometry import Geometry, Solid, vacuum
    from chroma_jax.loader import create_geometry_from_obj
    from chroma_jax.ops.geometry_pack import pack_geometry
    from chroma_jax.ops import mesh as mesh_ops
    from tests.test_intersect import random_rays

    geo = Geometry(vacuum)
    geo.add_solid(Solid(make.sphere(1.0, nsteps=12), vacuum, vacuum))
    geo = create_geometry_from_obj(geo, update_bvh_cache=False)
    origin, direction = random_rays(512, box=2.0, seed=3)

    geom1 = pack_geometry(geo)
    r1 = mesh_ops.intersect_mesh(jnp.asarray(origin),
                                 jnp.asarray(direction), geom1)

    geo.bvh = area_sort_children(geo.bvh)
    geom2 = pack_geometry(geo)
    r2 = mesh_ops.intersect_mesh(jnp.asarray(origin),
                                 jnp.asarray(direction), geom2)
    np.testing.assert_array_equal(np.asarray(r1[0]), np.asarray(r2[0]))
