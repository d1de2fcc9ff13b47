"""Contract test for the ROOT event IO (io/root.py) driven by the
fake PyROOT in tests/fake_root.py — ROOT is not installed in CI, so
this is what keeps the writer/reader schema code from rotting.

Checks the full logical schema round trip (reference io/root.C +
io/root.py:283-414): photons beg/end, flat hits, per-channel hits
map, vertices, channel readout, event ids.
"""
import importlib
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import event
from chroma_jax.generator.photon import photon_bomb


@pytest.fixture()
def rootio(monkeypatch):
    import tests.fake_root as fr
    monkeypatch.setitem(sys.modules, 'ROOT', fr.make_fake())
    sys.modules.pop('chroma_jax.io.root', None)
    mod = importlib.import_module('chroma_jax.io.root')
    assert mod.HAVE_ROOT
    yield mod
    sys.modules.pop('chroma_jax.io.root', None)


def make_event(i):
    ev = photon_bomb(20, 450.0, (1.0, 2.0, 3.0), t0=float(i))
    ev.id = i
    ev.vertices = [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 5.0,
                                t0=0.5)]
    ev.photons_end = ev.photons_beg[::2]
    ev.flat_hits = ev.photons_beg[:5]
    ev.flat_hits.channel = np.arange(5, dtype=np.uint32)
    ev.hits = {2: ev.photons_beg[:3], 7: ev.photons_beg[3:5]}
    ev.channels = event.Channels(
        hit=np.array([True, False, True]),
        t=np.array([1.5, 1e9, 2.5], np.float32),
        q=np.array([1.0, 0.0, 2.0], np.float32),
        flags=np.array([4, 0, 4], np.uint32))
    return ev


def test_root_round_trip(rootio, tmp_path):
    path = str(tmp_path / 'events.root')
    w = rootio.RootWriter(path)
    events = [make_event(0), make_event(1)]
    for ev in events:
        w.write_event(ev)
    w.close()

    r = rootio.RootReader(path)
    assert len(r) == 2
    for i, ev in enumerate(events):
        back = r.read_event(i)
        assert back.id == ev.id
        np.testing.assert_allclose(back.photons_beg.pos,
                                   ev.photons_beg.pos, rtol=1e-6)
        np.testing.assert_allclose(back.photons_beg.wavelengths,
                                   ev.photons_beg.wavelengths,
                                   rtol=1e-6)
        np.testing.assert_array_equal(back.photons_beg.flags,
                                      ev.photons_beg.flags)
        assert len(back.photons_end) == len(ev.photons_end)
        np.testing.assert_allclose(back.flat_hits.t, ev.flat_hits.t,
                                   rtol=1e-6)
        assert sorted(back.hits) == [2, 7]
        assert len(back.hits[2]) == 3 and len(back.hits[7]) == 2
        np.testing.assert_allclose(back.hits[7].pos, ev.hits[7].pos,
                                   rtol=1e-6)
        v = back.vertices[0]
        assert v.particle_name == 'e-'
        assert v.ke == 5.0 and v.t0 == 0.5
        np.testing.assert_array_equal(back.channels.hit,
                                      ev.channels.hit)
        np.testing.assert_allclose(back.channels.q, ev.channels.q)
        np.testing.assert_array_equal(back.channels.flags,
                                      ev.channels.flags)
    # reader navigation mirrors the reference event viewer contract
    assert r.next().id == 0
    assert r.next().id == 1
    assert r.prev().id == 0
    assert r.current().id == 0


def test_root_channel_info(rootio, tmp_path):
    class Det(object):
        channel_index_to_position = np.arange(9, dtype=float) \
            .reshape(3, 3)
        channel_index_to_channel_type = np.array([1, 1, 2])

    w = rootio.RootWriter(str(tmp_path / 'det.root'), detector=Det())
    w.write_event(make_event(0))
    w.close()
    r = rootio.RootReader(str(tmp_path / 'det.root'))
    ch = r.file.Get('CH')
    assert ch is not None and ch.GetEntries() == 1
    ch.GetEntry(0)
    assert ch.channel_pos.size() == 9
    assert [ch.channel_type[i] for i in range(3)] == [1, 1, 2]


def test_missing_root_raises_with_pointer(tmp_path, monkeypatch):
    """Without ROOT the constructors must fail loudly, pointing at the
    native npz format."""
    monkeypatch.setitem(sys.modules, 'ROOT', None)
    sys.modules.pop('chroma_jax.io.root', None)
    try:
        mod = importlib.import_module('chroma_jax.io.root')
        assert not mod.HAVE_ROOT
        with pytest.raises(ImportError, match='npz'):
            mod.RootWriter(str(tmp_path / 'x.root'))
    finally:
        sys.modules.pop('chroma_jax.io.root', None)
