"""Procedural mesh tests: closedness (watertightness) and volume checks."""
import numpy as np
import pytest

from chroma_jax import make
from chroma_jax.geometry import Mesh


def mesh_volume(mesh):
    """Signed volume via divergence theorem over triangles."""
    tv = mesh.vertices[mesh.triangles]
    v0, v1, v2 = tv[:, 0], tv[:, 1], tv[:, 2]
    return np.abs(np.einsum('ij,ij->i', v0,
                            np.cross(v1, v2)).sum() / 6.0)


def is_watertight(mesh):
    """Every edge shared by exactly two triangles."""
    t = mesh.triangles
    edges = np.concatenate([t[:, [0, 1]], t[:, [1, 2]], t[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    return (counts == 2).all()


@pytest.mark.parametrize('mesh,expected_volume,tol', [
    (make.cube(2.0), 8.0, 1e-4),
    (make.box(1.0, 2.0, 3.0), 6.0, 1e-4),
    (make.cylinder(1.0, 2.0, nsteps=256), 2 * np.pi, 1e-2),
    (make.sphere(1.0, nsteps=128), 4 * np.pi / 3, 1e-2),
])
def test_volumes(mesh, expected_volume, tol):
    assert np.isclose(mesh_volume(mesh), expected_volume,
                      rtol=tol)


@pytest.mark.parametrize('mesh', [
    make.cube(2.0),
    make.cylinder(1.0, 2.0, nsteps=32),
    make.sphere(1.0, nsteps=32),
    make.torus(0.5, 2.0, nsteps=32),
])
def test_watertight(mesh):
    assert is_watertight(mesh)


def test_rotate_extrude_orientation():
    """Sphere triangles must face outward (positive signed volume with
    outward normals)."""
    mesh = make.sphere(1.0, nsteps=64)
    tv = mesh.vertices[mesh.triangles]
    centers = tv.mean(axis=1)
    normals = np.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 1])
    # outward: normal . center > 0 for a sphere about origin
    outward_frac = (np.einsum('ij,ij->i', normals, centers) > 0).mean()
    assert outward_frac > 0.99


def test_linear_extrude_tapered():
    angles = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    m = make.linear_extrude(np.cos(angles), np.sin(angles), 2.0,
                            x2=0.5 * np.cos(angles),
                            y2=0.5 * np.sin(angles))
    assert is_watertight(m)
    lower, upper = m.get_bounds()
    assert np.isclose(upper[2] - lower[2], 2.0)
