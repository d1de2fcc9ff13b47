"""MBVH (wide fat-row BVH) build + traversal correctness."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from chroma_jax import make
from chroma_jax.bvh.mbvh import build_mbvh, ROW_WIDTH, BRANCH, TRI_ID_OFF
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.ops.geometry_pack import pack_geometry
from chroma_jax.ops import mbvh as mbvh_ops
from tests.test_intersect import brute_force, random_rays


def test_build_covers_all_triangles():
    mesh = make.sphere(50.0, nsteps=16)
    m = build_mbvh(mesh)
    rows = m.rows
    kinds = rows[:, 0] & 1
    counts = rows[:, 0] >> 8
    tri_ids = []
    for r in np.nonzero(kinds)[0]:
        k = counts[r]
        tri_ids.extend(rows[r, TRI_ID_OFF:TRI_ID_OFF + k].tolist())
    assert sorted(tri_ids) == list(range(len(mesh.triangles)))
    assert (counts <= BRANCH).all()
    assert rows.shape[1] == ROW_WIDTH


def test_tiny_mesh_single_cluster():
    ang = np.linspace(0, 2 * np.pi, 10, endpoint=False)
    mesh = make.convex_polygon(np.cos(ang), np.sin(ang))  # 8 triangles
    m = build_mbvh(mesh)
    assert m.nblocks == 0
    assert (m.rows[0, 0] & 1) == 1


@pytest.mark.parametrize('mesh_fn', [
    lambda: make.cube(2.0),
    lambda: make.sphere(1.5, nsteps=24),
    lambda: make.torus(0.5, 1.5, nsteps=16),
    lambda: make.sphere(1.5, nsteps=48),
])
def test_mbvh_matches_brute_force(mesh_fn):
    mesh = mesh_fn()
    geo = create_geometry_from_obj(mesh, update_bvh_cache=False)
    geom = pack_geometry(geo)
    origin, direction = random_rays(400)
    res = mbvh_ops.intersect_mesh(jnp.asarray(origin),
                                  jnp.asarray(direction), geom)
    tri_bf, dist_bf = brute_force(origin, direction, geo.mesh)

    tri = np.asarray(res['triangle'])
    dist = np.asarray(res['distance'])
    hit = tri_bf >= 0
    np.testing.assert_array_equal(tri >= 0, hit)
    np.testing.assert_allclose(dist[hit], dist_bf[hit], rtol=1e-4,
                               atol=1e-4)
    # normals: must be perpendicular-ish to nothing specific, but must
    # match the reported triangle's geometric normal
    tv = geo.mesh.vertices[geo.mesh.triangles[tri[hit]]]
    expect = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 1])
    got = np.asarray(res['normal'])[hit]
    cos = (expect * got).sum(1) / (
        np.linalg.norm(expect, axis=1) * np.linalg.norm(got, axis=1))
    np.testing.assert_allclose(cos, 1.0, atol=1e-5)


def test_mbvh_last_hit_skip():
    geo = create_geometry_from_obj(make.cube(2.0), update_bvh_cache=False)
    geom = pack_geometry(geo)
    origin = jnp.zeros((1, 3), jnp.float32)
    direction = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    r1 = mbvh_ops.intersect_mesh(origin, direction, geom)
    r2 = mbvh_ops.intersect_mesh(origin, direction, geom,
                                 last_hit_triangle=r1['triangle'])
    assert int(r1['triangle'][0]) != int(r2['triangle'][0])


def test_mbvh_material_codes_roundtrip():
    geo = create_geometry_from_obj(make.cube(2.0), update_bvh_cache=False)
    # fake distinct codes per triangle
    nt = len(geo.mesh.triangles)
    geo.inner_material_index = np.arange(nt, dtype=np.int32) % 3
    geo.outer_material_index = np.zeros(nt, dtype=np.int32)
    geom = pack_geometry(geo)
    origin = jnp.zeros((1, 3), jnp.float32)
    direction = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    res = mbvh_ops.intersect_mesh(origin, direction, geom)
    tri = int(res['triangle'][0])
    assert int(res['material_code'][0]) == int(geom.material_codes[tri])


def test_cascade_matches_plain_walker():
    """The cascade-shrinking walk (active at N >= CASCADE_MIN_N) must
    return bit-identical results to a single full-width loop."""
    import jax
    mesh = make.sphere(1.0, nsteps=24)
    geom = pack_geometry_for(mesh)
    n = max(mbvh_ops.CASCADE_MIN_N, 8192)
    origin, direction = random_rays(n, box=2.0, seed=11)
    origin = jnp.asarray(origin)
    direction = jnp.asarray(direction)
    # half the rays inactive, as in a propagating batch
    active = jnp.asarray(np.arange(n) % 2 == 0)

    res_c = mbvh_ops.intersect_mesh(origin, direction, geom,
                                    active=active)

    plain = mbvh_ops.CASCADE_MIN_N
    try:
        mbvh_ops.CASCADE_MIN_N = 1 << 30     # force the plain loop
        res_p = jax.jit(
            mbvh_ops.intersect_mesh.__wrapped__,
            static_argnames=('max_iters',))(origin, direction, geom,
                                            active=active)
    finally:
        mbvh_ops.CASCADE_MIN_N = plain

    np.testing.assert_array_equal(np.asarray(res_c['triangle']),
                                  np.asarray(res_p['triangle']))
    np.testing.assert_allclose(np.asarray(res_c['distance']),
                               np.asarray(res_p['distance']), rtol=1e-6)
    assert not np.asarray(res_c['incomplete']).any()


def pack_geometry_for(mesh):
    from chroma_jax.geometry import Geometry, vacuum, Solid
    geo = Geometry(vacuum)
    geo.add_solid(Solid(mesh, vacuum, vacuum))
    geo = create_geometry_from_obj(geo, update_bvh_cache=False)
    return pack_geometry(geo)
