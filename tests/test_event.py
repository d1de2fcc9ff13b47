"""Event model tests."""
import numpy as np

from chroma_jax import event
from chroma_jax.event import Photons, Vertex, Event, Channels


def make_photons(n, seed=0):
    rng = np.random.RandomState(seed)
    return Photons(pos=rng.rand(n, 3), dir=rng.rand(n, 3),
                   pol=rng.rand(n, 3),
                   wavelengths=rng.uniform(200, 800, n))


def test_photons_defaults():
    p = make_photons(10)
    assert len(p) == 10
    assert (p.t == 0).all()
    assert (p.last_hit_triangles == -1).all()
    assert (p.flags == 0).all()
    assert (p.weights == 1).all()
    assert p.pos.dtype == np.float32


def test_photons_join_add_slice():
    a, b = make_photons(5, 1), make_photons(7, 2)
    j = Photons.join([a, b])
    assert len(j) == 12
    assert np.allclose((a + b).pos, j.pos)
    sub = j[5:]
    assert np.allclose(sub.pos, b.pos)
    mask = j.wavelengths > 500
    assert len(j[mask]) == mask.sum()


def test_flags_match_reference_abi():
    assert event.NO_HIT == 1
    assert event.SURFACE_DETECT == 4
    assert event.BULK_REEMIT == 1 << 9
    assert event.NAN_ABORT == 1 << 31


def test_vertex_pdg():
    assert Vertex('e-', (0, 0, 0), (0, 0, 1), 1.0).pdgcode == 11
    assert Vertex('pi0', (0, 0, 0), (0, 0, 1), 1.0).pdgcode == 111


def test_channels_hit_channels():
    hit = np.array([True, False, True])
    t = np.array([1.0, 1e9, 3.0])
    q = np.array([1.0, 0.0, 2.0])
    ids, times, charges = Channels(hit, t, q).hit_channels()
    assert list(ids) == [0, 2]
    assert list(times) == [1.0, 3.0]


def test_event_vertices_scalar():
    v = Vertex('e-', (0, 0, 0), (0, 0, 1), 1.0)
    assert len(Event(vertices=v).vertices) == 1
