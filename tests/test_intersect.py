"""BVH traversal correctness: compare against brute-force all-triangles
intersection on small meshes (model: reference test/test_ray_intersection.py
golden-data test, but self-checking)."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401  (forces CPU backend)
import jax.numpy as jnp

from chroma_jax import make
from chroma_jax.geometry import Geometry, Solid, vacuum
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.ops.geometry_pack import pack_geometry
from chroma_jax.ops.mesh import intersect_mesh
from chroma_jax.ops.intersect import intersect_triangle


def brute_force(origin, direction, mesh):
    """All-triangles closest hit with the same epsilon rules."""
    tv = mesh.vertices[mesh.triangles]  # (T,3,3)
    o = jnp.asarray(origin)[:, None, :]
    d = jnp.asarray(direction)[:, None, :]
    hit, t = intersect_triangle(o, d, tv[None, :, 0], tv[None, :, 1],
                                tv[None, :, 2])
    t = jnp.where(hit, t, jnp.inf)
    best = jnp.argmin(t, axis=1)
    dist = t[jnp.arange(len(origin)), best]
    tri = jnp.where(jnp.isfinite(dist), best, -1)
    return np.asarray(tri), np.asarray(dist)


def build_geom(obj):
    geo = create_geometry_from_obj(obj, update_bvh_cache=False)
    return pack_geometry(geo), geo.mesh


def random_rays(n, box=3.0, seed=42):
    rng = np.random.RandomState(seed)
    origin = rng.uniform(-box, box, (n, 3)).astype(np.float32)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1)[:, None]
    return origin, direction


@pytest.mark.parametrize('mesh_fn', [
    lambda: make.cube(2.0),
    lambda: make.sphere(1.5, nsteps=24),
    lambda: make.torus(0.5, 1.5, nsteps=16),
])
def test_traversal_matches_brute_force(mesh_fn):
    geom, mesh = build_geom(mesh_fn())
    origin, direction = random_rays(500)
    tri, dist = intersect_mesh(jnp.asarray(origin), jnp.asarray(direction),
                               geom)
    tri_bf, dist_bf = brute_force(origin, direction, mesh)

    tri = np.asarray(tri)
    dist = np.asarray(dist)
    hit = tri_bf >= 0
    # same hit/miss classification
    np.testing.assert_array_equal(tri >= 0, hit)
    # same distances (triangle ids can differ at shared edges)
    np.testing.assert_allclose(dist[hit], dist_bf[hit], rtol=1e-4,
                               atol=1e-4)


def test_rays_from_inside_sphere():
    geom, mesh = build_geom(make.sphere(100.0, nsteps=32))
    n = 200
    rng = np.random.RandomState(7)
    direction = rng.normal(size=(n, 3)).astype(np.float32)
    direction /= np.linalg.norm(direction, axis=1)[:, None]
    origin = np.zeros((n, 3), dtype=np.float32)
    tri, dist = intersect_mesh(jnp.asarray(origin), jnp.asarray(direction),
                               geom)
    assert (np.asarray(tri) >= 0).all()
    # all hits at roughly the sphere radius
    np.testing.assert_allclose(np.asarray(dist), 100.0, rtol=0.02)


def test_last_hit_triangle_skipped():
    geom, mesh = build_geom(make.cube(2.0))
    origin = jnp.asarray([[0.0, 0.0, 0.0]], dtype=jnp.float32)
    direction = jnp.asarray([[0.0, 0.0, 1.0]], dtype=jnp.float32)
    tri, dist = intersect_mesh(origin, direction, geom)
    tri2, dist2 = intersect_mesh(origin, direction, geom,
                                 last_hit_triangle=tri)
    assert int(tri[0]) != int(tri2[0])


def test_multi_solid_scene():
    geo = Geometry(vacuum)
    geo.add_solid(Solid(make.cube(1.0), vacuum, vacuum))
    geo.add_solid(Solid(make.cube(1.0), vacuum, vacuum),
                  displacement=(5.0, 0, 0))
    geo.flatten()
    geo = create_geometry_from_obj(geo, update_bvh_cache=False)
    geom = pack_geometry(geo)
    origin = jnp.asarray([[-3.0, 0.0, 0.0], [2.5, 0.0, 0.0]],
                         dtype=jnp.float32)
    direction = jnp.asarray([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]],
                            dtype=jnp.float32)
    tri, dist = intersect_mesh(origin, direction, geom)
    np.testing.assert_allclose(np.asarray(dist), [2.5, 2.0], atol=1e-5)
    # ray 2 must hit solid 1 (the displaced cube)
    assert int(geo.solid_id[int(tri[1])]) == 1
