"""Demo 3D models (role parity: chroma/models — STL showpieces).

Instead of shipping binary STL assets, the demo models here are
generated procedurally; each attribute is a ``Solid`` ready for
``@chroma_jax.models.<name>`` geometry strings.
"""
import numpy as np

from chroma_jax.geometry import Mesh, Solid
from chroma_jax import make
from chroma_jax.demo.optics import vacuum, water, shiny_surface


def _trefoil_points(n=400, scale=400.0):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    x = np.sin(t) + 2 * np.sin(2 * t)
    y = np.cos(t) - 2 * np.cos(2 * t)
    z = -np.sin(3 * t)
    return scale * np.column_stack([x, y, z])


def tube_along_curve(points, radius=80.0, nsides=16):
    """Sweep a circle along a closed 3D curve -> closed tube Mesh."""
    points = np.asarray(points, dtype=float)
    n = len(points)
    # parallel-transport-ish frames
    tangents = np.roll(points, -1, axis=0) - np.roll(points, 1, axis=0)
    tangents /= np.linalg.norm(tangents, axis=1)[:, None]
    ref = np.array([0.0, 0.0, 1.0])
    normals = np.cross(tangents, ref)
    small = np.linalg.norm(normals, axis=1) < 1e-6
    normals[small] = np.cross(tangents[small], [1.0, 0.0, 0.0])
    normals /= np.linalg.norm(normals, axis=1)[:, None]
    binormals = np.cross(tangents, normals)

    phi = np.linspace(0, 2 * np.pi, nsides, endpoint=False)
    circle = np.stack([np.cos(phi), np.sin(phi)], axis=1)  # (nsides,2)
    verts = (points[:, None, :]
             + radius * (circle[None, :, 0, None] * normals[:, None, :]
                         + circle[None, :, 1, None] * binormals[:, None, :]))
    verts = verts.reshape(-1, 3)

    ring = np.arange(n)[:, None] * nsides + np.arange(nsides)[None, :]
    ring_next = np.roll(ring, -1, axis=0)
    side_next = np.roll(ring, -1, axis=1)
    diag = np.roll(ring_next, -1, axis=1)
    t1 = np.stack([ring, ring_next, diag], axis=-1).reshape(-1, 3)
    t2 = np.stack([ring, diag, side_next], axis=-1).reshape(-1, 3)
    return Mesh(verts, np.concatenate([t1, t2]))


def lionsolid():
    """Showpiece solid (a trefoil knot) standing in for the reference's
    lion statue model."""
    mesh = tube_along_curve(_trefoil_points(), radius=120.0, nsides=24)
    return Solid(mesh, water, vacuum, color=0x99ffcc66)


def companioncube():
    """Beveled cube showpiece."""
    mesh = make.cube(1000.0)
    return Solid(mesh, water, vacuum, color=0x99ccccff)


def liberty():
    """Tall showpiece: stacked cylinders + sphere."""
    base = make.cylinder(400.0, 200.0, nsteps=32)
    shaft = make.cylinder(150.0, 1200.0, nsteps=32)
    head = make.sphere(220.0, nsteps=32)
    mesh = base
    sv = shaft.vertices.copy()
    sv[:, 1] += 700.0
    mesh = mesh + Mesh(sv, shaft.triangles)
    hv = head.vertices.copy()
    hv[:, 1] += 1500.0
    mesh = mesh + Mesh(hv, head.triangles)
    return Solid(mesh, water, vacuum, color=0x99ccffcc)


def tie_interceptor6():
    """Showpiece: ball between two angled panels."""
    ball = make.sphere(300.0, nsteps=32)
    panel = make.box(40.0, 900.0, 900.0)
    mesh = ball
    for dx in (-450.0, 450.0):
        pv = panel.vertices.copy()
        pv[:, 0] += dx
        mesh = mesh + Mesh(pv, panel.triangles)
    return Solid(mesh, water, vacuum, color=0x99ffaaaa)
