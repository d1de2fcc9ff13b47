"""Detector + DAQ statistical tests (model: reference
test/test_detector.py — PMT time/charge smearing distributions) and
PDF consistency tests (reference test/test_pdf.py)."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import event, make
from chroma_jax.geometry import Solid, vacuum
from chroma_jax.detector import Detector
from chroma_jax.demo.optics import r7081hqe_photocathode
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.sim import Simulation
from chroma_jax.generator.photon import photon_bomb


@pytest.fixture(scope='module')
def pmt_sim():
    cube = Detector(vacuum)
    cube.add_pmt(Solid(make.box(10.0, 10.0, 10.0), vacuum, vacuum,
                       surface=r7081hqe_photocathode))
    cube.set_time_dist_gaussian(1.2, -6.0, 6.0)
    cube.set_charge_dist_gaussian(1.0, 0.1, 0.5, 1.5)
    geo = create_geometry_from_obj(cube, update_bvh_cache=False)
    return Simulation(geo, geant4_processes=0, seed=12345)


def _single_photon_batch(n):
    """n identical photons aimed at the PMT; each propagated in one
    batched sim call (statistically equivalent to the reference's 1000
    single-photon events, far cheaper to run)."""
    pos = np.zeros((n, 3), dtype=np.float32)
    dir = np.tile([0, 0, 1], (n, 1)).astype(np.float32)
    phi = np.random.RandomState(2).uniform(0, 2 * np.pi, n)
    pol = np.zeros_like(pos)
    pol[:, 0] = np.cos(phi)
    pol[:, 1] = np.sin(phi)
    t = np.full(n, 100.0, dtype=np.float32)
    return event.Photons(pos=pos, dir=dir, pol=pol, t=t,
                         wavelengths=np.full(n, 400.0, np.float32))


def test_daq_time_charge_distributions(pmt_sim):
    """Hit time std ~ 1.2 ns, charge ~ 1.0 +- 0.1 (reference:
    test_detector.py testTime/testCharge)."""
    hit_times, hit_charges = [], []
    batches = [_single_photon_batch(1) for _ in range(400)]
    for ev in pmt_sim.simulate(iter(batches), run_daq=True,
                               photons_per_batch=1):
        if ev.channels.hit[0]:
            hit_times.append(float(ev.channels.t[0]))
            hit_charges.append(float(ev.channels.q[0]))
    hit_times = np.asarray(hit_times)
    hit_charges = np.asarray(hit_charges)
    assert len(hit_times) > 30  # QE at 400nm ~ 32%
    assert abs(hit_times.std() - 1.2) < 0.25
    assert abs(hit_charges.mean() - 1.0) < 0.1
    assert abs(hit_charges.std() - 0.1) < 0.1


def test_flat_hits(pmt_sim):
    photons = _single_photon_batch(2000)
    ev = next(pmt_sim.simulate(photons, keep_flat_hits=True))
    assert ev.flat_hits is not None
    assert len(ev.flat_hits) > 400
    assert (ev.flat_hits.channel == 0).all()
    assert ((ev.flat_hits.flags & event.SURFACE_DETECT) > 0).all()


def test_create_pdf_consistency(pmt_sim):
    """sum of each channel's pdf equals its hitcount (reference:
    test_pdf.py)."""
    # small bombs so the per-event summed charge stays inside qrange
    events = [photon_bomb(8, 400.0, (0, 0, 0), t0=10.0)
              for _ in range(6)]
    photon_iter = iter([ev.photons_beg for ev in events])
    hitcount, pdf = pmt_sim.create_pdf(photon_iter, 100, (-0.5, 999.5),
                                       10, (-0.5, 9.5))
    assert (hitcount > 0).any()
    assert (pdf > 0).any()
    for i, nhits in enumerate(hitcount):
        assert nhits == pdf[i].sum()


def test_eval_pdf_runs(pmt_sim):
    """Variable-bin PDF evaluation end-to-end."""
    ev_photons = photon_bomb(2000, 400.0, (0, 0, 0), t0=100.0).photons_beg
    ev = next(pmt_sim.simulate(ev_photons, run_daq=True))
    assert ev.channels is not None

    iterable = iter([photon_bomb(2000, 400.0, (0, 0, 0),
                                 t0=100.0).photons_beg
                     for _ in range(2)])
    hitcount, pdf_value, pdf_uncert = pmt_sim.eval_pdf(
        ev.channels, iterable, 0.5, (-0.5, 999.5), 1, (-0.5, 9.5),
        min_bin_content=10, nreps=2, ndaq=4)
    if ev.channels.hit[0]:
        assert hitcount[0] > 0
        assert pdf_value[0] >= 0
