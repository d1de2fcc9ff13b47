"""Contract test for the Geant4 backend (generator/g4gen.py) driven by
the fake geant4_pybind in tests/fake_geant4.py.

Geant4 is not installed in CI, so g4gen.py would otherwise be dead
code; this verifies its real harvester / stepping-action / gun wiring,
unit conversions, flag mapping, per-step scintillation hook, and track
recording against a scripted event — and that the Photons/Vertex it
emits carry the same schema the native TrackGenerator produces.
Reference behavior: chroma/generator/g4gen.py:64-163 +
src/G4chroma.cc:46-206.
"""
import copy
import importlib
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import event
from chroma_jax.demo.optics import water

HBARC_MEV_NM = 197.3269804e-6


def _scint_material():
    mat = copy.deepcopy(water)
    lam = np.linspace(350.0, 450.0, 21)
    mat.scintillation_spectrum = np.column_stack([lam,
                                                  np.ones_like(lam)])
    mat.scintillation_light_yield = 100.0        # photons / MeV
    mat.scintillation_waveform = np.array([[-10.0, 1.0]])
    return mat


@pytest.fixture()
def g4gen(monkeypatch):
    import tests.fake_geant4 as fg
    monkeypatch.setitem(sys.modules, 'geant4_pybind', fg.make_fake())
    sys.modules.pop('chroma_jax.generator.g4gen', None)
    mod = importlib.import_module('chroma_jax.generator.g4gen')
    yield mod
    sys.modules.pop('chroma_jax.generator.g4gen', None)


def test_material_conversion(g4gen):
    """Material tables convert to ascending-energy G4 properties with
    the reference's wavelength->energy flip (g4gen.py:22)."""
    g4mat = g4gen.create_g4material(_scint_material())
    e, v = g4mat.table.props['RINDEX']
    assert all(b > a for a, b in zip(e, e[1:]))   # ascending energies
    assert 'SCINTILLATIONYIELD' in g4mat.table.consts
    assert g4mat.table.consts['SCINTILLATIONTIMECONSTANT1'] == 10.0
    assert g4mat.elements  # composition transferred


def test_generate_photons_harvest_and_scint(g4gen):
    gen = g4gen.G4Generator(_scint_material(), seed=12)
    v = event.Vertex('e-', (10.0, 0.0, 0.0), (0.0, 0.0, 1.0), 1.0)
    photons = gen.generate_photons([v])
    assert isinstance(photons, event.Photons)

    flags = photons.flags
    cher = (flags & event.CHERENKOV) != 0
    scint = (flags & event.SCINTILLATION) != 0
    # exactly the one scripted Cherenkov photon, at 2.5 eV
    assert cher.sum() == 1
    expect_wl = 2 * np.pi * HBARC_MEV_NM / 2.5e-6
    np.testing.assert_allclose(photons.wavelengths[cher], expect_wl,
                               rtol=1e-5)
    np.testing.assert_allclose(photons.pol[cher][0], [0.0, 0.0, 1.0])
    # scintillation from 1 MeV deposited at 100 photons/MeV
    assert 60 < scint.sum() < 160
    # emission points lie on the scripted 8 mm track from (10,0,0)
    sp = photons.pos[scint]
    np.testing.assert_allclose(sp[:, 0], 10.0, atol=1e-5)
    assert (sp[:, 2] >= -1e-5).all() and (sp[:, 2] <= 8.0 + 1e-5).all()
    # spectrum sampled from the configured 350-450 nm table
    wl = photons.wavelengths[scint]
    assert (wl >= 349.0).all() and (wl <= 451.0).all()


def test_tracking_vertex_tree(g4gen):
    gen = g4gen.G4Generator(_scint_material(), seed=5)
    v = event.Vertex('e-', (0.0, 0.0, 0.0), (0.0, 0.0, 1.0), 2.0)
    tracked, photons, parent_ids = gen.generate_photons(
        [v], tracking=True)
    assert len(tracked) == 1
    tv = tracked[0]
    assert isinstance(tv, event.Vertex)
    assert tv.particle_name == 'e-'
    assert tv.pdgcode == 11
    # scripted track: pre + two post points, 8 mm along +z
    assert len(tv.steps.x) == 3
    np.testing.assert_allclose(tv.steps.z, [0.0, 5.0, 8.0], atol=1e-6)
    np.testing.assert_allclose(np.sum(tv.steps.edep), 2.0, rtol=1e-6)
    assert tv.children == []
    # every harvested photon points back at the primary track
    assert len(parent_ids) == len(photons)
    assert (parent_ids == 1).all()


def test_schema_matches_trackgen(g4gen):
    """The Geant4 backend and the native TrackGenerator must emit
    interchangeable Photons (the worker pool treats them as equals)."""
    from chroma_jax.generator.trackgen import TrackGenerator
    mat = _scint_material()
    g4photons = g4gen.G4Generator(mat, seed=3).generate_photons(
        [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 1.0)])
    tg = TrackGenerator(mat, seed=3)
    tphotons = tg.generate_photons(
        [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 1.0)])
    for attr in ('pos', 'dir', 'pol', 'wavelengths', 't', 'flags',
                 'weights', 'evidx'):
        a = getattr(g4photons, attr)
        b = getattr(tphotons, attr)
        assert a.dtype == b.dtype, attr
        assert a.shape[1:] == b.shape[1:], attr
