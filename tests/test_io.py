"""Event IO round-trip tests (model: reference ROOT IO round trip,
test strategy SURVEY.md §4) using the native npz format."""
import numpy as np

import tests.conftest  # noqa: F401

from chroma_jax import event
from chroma_jax.io.npz import NpzWriter, NpzReader
from chroma_jax.io import npz
from chroma_jax.generator.photon import photon_bomb


def make_event(i):
    ev = photon_bomb(50, 450.0, (1.0, 2.0, 3.0), t0=float(i))
    ev.id = i
    ev.vertices = [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 5.0, t0=0.5)]
    ev.photons_end = ev.photons_beg[::2]
    ev.flat_hits = ev.photons_beg[:5]
    ev.flat_hits.channel = np.arange(5, dtype=np.uint32)
    ev.channels = event.Channels(
        hit=np.array([True, False, True]),
        t=np.array([1.5, 1e9, 2.5], np.float32),
        q=np.array([1.0, 0.0, 2.0], np.float32),
        flags=np.array([4, 0, 4], np.uint32))
    return ev


def test_npz_round_trip(tmp_path):
    path = str(tmp_path / 'events.npz')
    with NpzWriter(path) as w:
        for i in range(3):
            w.write_event(make_event(i))

    r = NpzReader(path)
    assert len(r) == 3
    evs = list(r)
    for i, ev in enumerate(evs):
        assert ev.id == i
        assert len(ev.photons_beg) == 50
        assert np.allclose(ev.photons_beg.t, float(i))
        assert len(ev.photons_end) == 25
        assert len(ev.flat_hits) == 5
        assert (ev.flat_hits.channel == np.arange(5)).all()
        assert ev.vertices[0].particle_name == 'e-'
        assert ev.vertices[0].ke == 5.0
        assert ev.channels.hit.sum() == 2
        np.testing.assert_allclose(ev.channels.q, [1.0, 0.0, 2.0])


def test_npz_reader_navigation(tmp_path):
    path = str(tmp_path / 'events.npz')
    with NpzWriter(path) as w:
        for i in range(3):
            w.write_event(make_event(i))
    r = NpzReader(path)
    assert r.next().id == 0
    assert r.next().id == 1
    assert r.prev().id == 0
    assert r.prev().id == 2


def test_npz_full_schema_round_trip(tmp_path):
    """Full reference-schema round trip: photons beg/end, flat hits,
    hits map, photon tracks, vertices with steps + children, channels
    (reference io/root.py:283-414 schema)."""
    rng = np.random.RandomState(0)

    def mkphotons(n, channel=False):
        p = event.Photons(
            pos=rng.normal(size=(n, 3)).astype(np.float32),
            dir=rng.normal(size=(n, 3)).astype(np.float32),
            pol=rng.normal(size=(n, 3)).astype(np.float32),
            wavelengths=rng.uniform(300, 600, n).astype(np.float32),
            t=rng.uniform(0, 50, n).astype(np.float32),
            flags=rng.randint(0, 2 ** 16, n).astype(np.uint32))
        if channel:
            p.channel = rng.randint(0, 8, n).astype(np.uint32)
        return p

    ev = event.Event(id=42)
    ev.photons_beg = mkphotons(25)
    ev.photons_end = mkphotons(25)
    ev.flat_hits = mkphotons(7, channel=True)
    ev.hits = {3: mkphotons(4), 5: mkphotons(2)}
    ev.photon_tracks = [mkphotons(6), mkphotons(1)]
    child = event.Vertex('gamma', (1, 2, 3), (0, 0, 1), 2.5, t0=0.3)
    v = event.Vertex('e-', (0, 0, 0), (1, 0, 0), 10.0, children=[child])
    ns = 5
    v.steps = event.Steps(*[rng.uniform(size=ns).astype(np.float32)
                            for _ in range(10)])
    ev.vertices = [v]
    ev.channels = event.Channels(
        hit=np.array([0, 1, 0, 1], bool),
        t=np.array([1e9, 3.5, 1e9, 8.25], np.float32),
        q=np.array([0, 1.5, 0, 0.75], np.float32),
        flags=np.array([0, 1, 0, 9], np.uint32))

    path = str(tmp_path / 'full.npz')
    with npz.NpzWriter(path) as w:
        w.write_event(ev)

    back = npz.NpzReader(path).read_event(0)
    assert back.id == 42
    for field in ('photons_beg', 'photons_end', 'flat_hits'):
        a, b = getattr(ev, field), getattr(back, field)
        np.testing.assert_array_equal(a.pos, b.pos)
        np.testing.assert_array_equal(a.wavelengths, b.wavelengths)
        np.testing.assert_array_equal(a.flags, b.flags)
    np.testing.assert_array_equal(ev.flat_hits.channel,
                                  back.flat_hits.channel)
    assert sorted(back.hits) == [3, 5]
    np.testing.assert_array_equal(ev.hits[3].t, back.hits[3].t)
    assert len(back.photon_tracks) == 2
    np.testing.assert_array_equal(ev.photon_tracks[0].pos,
                                  back.photon_tracks[0].pos)
    bv = back.vertices[0]
    assert bv.particle_name == 'e-' and bv.ke == 10.0
    np.testing.assert_allclose(bv.steps.x, v.steps.x)
    np.testing.assert_allclose(bv.steps.qedep, v.steps.qedep)
    assert bv.children[0].particle_name == 'gamma'
    assert bv.children[0].ke == 2.5
    np.testing.assert_array_equal(back.channels.hit, ev.channels.hit)
    np.testing.assert_array_equal(back.channels.flags, ev.channels.flags)


def test_npz_streaming(tmp_path):
    """Events are on disk before close() (streaming writer)."""
    import os
    path = str(tmp_path / 'stream.npz')
    w = npz.NpzWriter(path)
    p = event.Photons(pos=np.zeros((1000, 3), np.float32),
                      dir=np.zeros((1000, 3), np.float32),
                      pol=np.zeros((1000, 3), np.float32),
                      wavelengths=np.zeros(1000, np.float32),
                      t=np.zeros(1000, np.float32))
    w.write_event(event.Event(id=0, photons_beg=p))
    size_mid = os.path.getsize(path)
    assert size_mid > 1000          # first event already flushed
    w.write_event(event.Event(id=1, photons_beg=p))
    w.close()
    r = npz.NpzReader(path)
    assert len(r) == 2 and r.read_event(1).id == 1
