"""Contract test for the flat-ntuple writer (io/ntuple.py) driven by
the fake uproot/awkward in tests/fake_uproot.py — uproot is not
installed in CI, so this is what keeps the branch schema from rotting
(reference: chroma/io/ntuple.py:100-194 — metadata tree with channel
positions/types, per-event vertex/mcpe/hit records)."""
import importlib
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import event
from chroma_jax.generator.photon import photon_bomb


@pytest.fixture()
def ntio(monkeypatch):
    import tests.fake_uproot as fu
    uproot, awkward = fu.make_fakes()
    monkeypatch.setitem(sys.modules, 'uproot', uproot)
    monkeypatch.setitem(sys.modules, 'awkward', awkward)
    sys.modules.pop('chroma_jax.io.ntuple', None)
    mod = importlib.import_module('chroma_jax.io.ntuple')
    assert mod.HAVE_UPROOT
    fu.FILES.clear()
    yield mod, fu
    sys.modules.pop('chroma_jax.io.ntuple', None)


def make_event(i):
    ev = photon_bomb(20, 450.0, (1.0, 2.0, 3.0), t0=float(i))
    ev.id = i
    ev.vertices = [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 5.0,
                                t0=0.5)]
    ev.photons_end = ev.photons_beg[::2]
    ev.flat_hits = ev.photons_beg[:5]
    ev.flat_hits.channel = np.arange(5, dtype=np.uint32)
    ev.channels = event.Channels(
        hit=np.array([True, False, True]),
        t=np.array([1.5, 1e9, 2.5], np.float32),
        q=np.array([1.0, 0.0, 2.0], np.float32),
        flags=np.array([4, 0, 4], np.uint32))
    return ev


class Det(object):
    channel_index_to_position = np.arange(9, dtype=float).reshape(3, 3)
    channel_index_to_channel_type = np.array([1, 1, 2])


def test_ntuple_schema(ntio, tmp_path):
    mod, fu = ntio
    path = str(tmp_path / 'events.ntuple')
    with mod.NTupleWriter(path, detector=Det(),
                          write_mcphotons=True) as w:
        for i in range(2):
            w.write_event(make_event(i))

    f = fu.FILES[path]
    assert f.closed

    # ---- metadata tree (channel positions and types) ----------------
    md = f.trees['metadata']
    np.testing.assert_array_equal(md['n_channels'], [3])
    np.testing.assert_allclose(md['ch_pos_x'][0], [0.0, 3.0, 6.0])
    np.testing.assert_allclose(md['ch_pos_z'][0], [2.0, 5.0, 8.0])
    np.testing.assert_array_equal(md['ch_types'][0], [1, 1, 2])

    # ---- events tree -------------------------------------------------
    evs = f.trees['events']
    np.testing.assert_array_equal(evs['evid'], [0, 1])

    for i in range(2):
        vtx = evs['vertex'][i]
        assert len(vtx) == 1
        np.testing.assert_array_equal(vtx['pdg'], [11])      # e-
        np.testing.assert_allclose(vtx['ke'], [5.0])
        np.testing.assert_allclose(vtx['t'], [0.5])
        np.testing.assert_allclose(vtx['w'], [1.0])

        beg = evs['photons_beg'][i]
        assert len(beg) == 20
        np.testing.assert_allclose(beg['x'], np.ones(20))
        np.testing.assert_allclose(beg['t'], np.full(20, float(i)))
        np.testing.assert_allclose(beg['wavelength'],
                                   np.full(20, 450.0))
        assert len(evs['photons_end'][i]) == 10

        mcpe = evs['mcpe'][i]
        assert len(mcpe) == 5
        np.testing.assert_array_equal(mcpe['channel'],
                                      np.arange(5))

        hit = evs['hit'][i]
        np.testing.assert_array_equal(hit['pmt'], [0, 2])
        np.testing.assert_allclose(hit['time'], [1.5, 2.5])
        np.testing.assert_allclose(hit['charge'], [1.0, 2.0])


def test_ntuple_heterogeneous_rows(ntio, tmp_path):
    """Events missing a record pad with an empty array, mirroring the
    reference's optional branches."""
    mod, fu = ntio
    path = str(tmp_path / 'pad.ntuple')
    ev0 = make_event(0)
    ev1 = make_event(1)
    ev1.vertices = []          # no vertex record for event 1
    ev1.channels = None        # no hit record either
    with mod.NTupleWriter(path) as w:
        w.write_event(ev0)
        w.write_event(ev1)
    evs = fu.FILES[path].trees['events']
    assert len(evs['vertex'][0]) == 1
    assert len(evs['vertex'][1]) == 0
    assert len(evs['hit'][0]) == 2
    assert len(evs['hit'][1]) == 0


def test_missing_uproot_raises_with_pointer(tmp_path, monkeypatch):
    """Without uproot the constructor must fail loudly, pointing at
    the native npz format."""
    monkeypatch.setitem(sys.modules, 'uproot', None)
    monkeypatch.setitem(sys.modules, 'awkward', None)
    sys.modules.pop('chroma_jax.io.ntuple', None)
    try:
        mod = importlib.import_module('chroma_jax.io.ntuple')
        assert not mod.HAVE_UPROOT
        with pytest.raises(ImportError, match='npz'):
            mod.NTupleWriter(str(tmp_path / 'x.ntuple'))
    finally:
        sys.modules.pop('chroma_jax.io.ntuple', None)
