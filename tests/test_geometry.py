"""Core data-model tests (model: reference test/test_bvh.py fixtures +
geometry semantics)."""
import numpy as np
import pytest

from chroma_jax.geometry import (Mesh, Solid, Material, Surface, Geometry,
                                 vacuum, standard_wavelengths)
from chroma_jax import make


def test_mesh_validation():
    with pytest.raises(ValueError):
        Mesh([[0, 0, 0]], [[0, 0]])
    with pytest.raises(ValueError):
        Mesh([[0, 0, 0]], [[0, 0, 5]])


def test_mesh_dedup_and_null_removal():
    verts = [[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 0]]
    tris = [[0, 1, 2], [3, 1, 2], [1, 1, 2]]
    m = Mesh(verts, tris, remove_duplicate_vertices=True)
    assert len(m.vertices) == 3
    # triangle [1,1,2] is degenerate and removed; [0,1,2] and [3,1,2]
    # become identical after dedup
    assert len(m.triangles) == 2
    assert (m.triangles[0] == m.triangles[1]).all()


def test_mesh_md5_stable():
    m1 = make.cube(1.0)
    m2 = make.cube(1.0)
    assert m1.md5() == m2.md5()
    assert m1.md5() != make.cube(2.0).md5()


def test_solid_broadcast():
    m = make.cube(1.0)
    s = Solid(m, vacuum, vacuum)
    assert len(s.inner_material) == len(m.triangles)
    assert len(s.unique_materials) == 1


def test_material_set():
    mat = Material('test')
    mat.set('refractive_index', 1.33)
    assert mat.refractive_index.shape == (len(standard_wavelengths), 2)
    assert np.allclose(mat.refractive_index[:, 1], 1.33)
    mat.set('absorption_length', [1, 2, 3], wavelengths=[100, 200, 300])
    assert mat.absorption_length.shape == (3, 2)


def test_surface_rejects_negative():
    surf = Surface('test')
    with pytest.raises(Exception):
        surf.set('detect', -0.5)


def test_geometry_flatten():
    geo = Geometry(vacuum)
    s = Solid(make.cube(1.0), vacuum, vacuum)
    geo.add_solid(s)
    geo.add_solid(s, displacement=(10, 0, 0))
    geo.flatten()
    nt = len(s.mesh.triangles)
    assert len(geo.mesh.triangles) == 2 * nt
    assert (geo.solid_id[:nt] == 0).all()
    assert (geo.solid_id[nt:] == 1).all()
    assert len(geo.unique_materials) == 1
    assert (geo.surface_index == -1).all()
    # displaced cube occupies x in [9.5, 10.5]
    lower, upper = geo.mesh.get_bounds()
    assert np.isclose(upper[0], 10.5)
    assert np.isclose(lower[0], -0.5)


def test_geometry_flatten_rotation():
    geo = Geometry(vacuum)
    s = Solid(make.box(2.0, 1.0, 1.0), vacuum, vacuum)
    rot = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
    geo.add_solid(s, rotation=rot)
    geo.flatten()
    lower, upper = geo.mesh.get_bounds()
    # box rotated 90 deg about z: long axis now along y
    assert np.isclose(upper[1] - lower[1], 2.0, atol=1e-5)
    assert np.isclose(upper[0] - lower[0], 1.0, atol=1e-5)
