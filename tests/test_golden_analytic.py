"""Non-circular golden validation: every expected number here is
derived in closed form (or by quadrature over the detector's own
configured smearing tables), independently of the propagation engine.

Fixture: a photon bomb at the center of a sphere whose entire inner
wall is one photocathode channel, in a non-scattering medium.  Then

  * every photon travels exactly R, arriving at t0 = R n / c;
  * the detection fraction is exp(-R/L_abs) * QE exactly
    (detect + absorb = 1 at the wall, so there are no reflections);
  * the DAQ channel time is t0 + min of m smearing draws, and since
    the inverse-CDF sampler is monotonic, min_i icdf(u_i) =
    icdf(min_i u_i) with min_i u_i ~ Beta(1, m) — a 1-D quadrature
    over the detector's own table;
  * the DAQ channel charge is the sum of m one-PE draws from the
    charge table (plus known quantization).

This is the BASELINE.md acceptance shape ("hit-time/charge PDFs
matching") with golden numbers the engine under test did not produce.
Reference physics: chroma/cuda/photon.h (bulk absorb, surface
detect), chroma/cuda/daq.cu (earliest smeared time, charge sum).
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import make
from chroma_jax.geometry import Material, Solid, Surface
from chroma_jax.detector import Detector

# the configuration is shared with tools/make_golden_reference.py (the
# CUDA-reference generator) via tools/golden_config.py, so both engines
# face these exact closed-form expectations by construction
from tools.golden_config import (build_analytic_sphere, SPHERE_R as R,
                                 SPHERE_QE as QE,
                                 SPHERE_SURVIVE_BULK as SURVIVE_BULK,
                                 SPHERE_N as N_MEDIUM,
                                 SPHERE_T_RMS as T_RMS,
                                 SPHERE_NPHOTONS as NPHOTONS,
                                 SPHERE_NEVENTS as NEVENTS,
                                 SPHERE_WAVELENGTH, SPHERE_SEED,
                                 SPHERE_NSTEPS)

C_MM_NS = 299.792458

T0 = R * N_MEDIUM / C_MM_NS
P_DETECT = SURVIVE_BULK * QE


@pytest.fixture(scope='module')
def sphere_sim():
    det = build_analytic_sphere(make, Solid, Material, Surface,
                                Detector)
    from chroma_jax.sim import Simulation
    return Simulation(det, geant4_processes=0, seed=SPHERE_SEED)


def _events(sim):
    from chroma_jax.generator.photon import photon_bomb
    for i in range(NEVENTS):
        yield next(sim.simulate(
            [photon_bomb(NPHOTONS, SPHERE_WAVELENGTH, (0.0, 0.0, 0.0))],
            run_daq=True, keep_photons_end=True))


def _table_moments(icdf):
    """Mean/variance of a distribution given its tabulated inverse CDF
    on a uniform u-grid (how the DAQ actually samples)."""
    v = np.asarray(icdf, dtype=np.float64)
    return float(np.mean(v)), float(np.var(v))


def _min_of_m_moments(icdf, m):
    """Moments of min over m draws from the tabulated inverse CDF:
    min_i icdf(u_i) = icdf(Beta(1, m)) by monotonicity."""
    v = np.asarray(icdf, dtype=np.float64)
    u = np.linspace(0.0, 1.0, len(v))
    # density of min of m uniforms: m (1-u)^(m-1)
    w = m * (1.0 - u) ** (m - 1)
    w /= np.trapezoid(w, u)
    mean = np.trapezoid(w * v, u)
    var = np.trapezoid(w * (v - mean) ** 2, u)
    return float(mean), float(var)


@pytest.mark.slow
def test_analytic_detection_fraction_and_tof(sphere_sim):
    det_fracs, t_unsmeared = [], []
    for ev in _events(sphere_sim):
        hits = ev.flat_hits
        det_fracs.append(len(hits) / float(NPHOTONS))
        t_unsmeared.append(np.asarray(hits.t))

    # detection fraction: exp(-R/L_abs) * QE, Poisson errors only
    frac = float(np.mean(det_fracs))
    sigma = np.sqrt(P_DETECT * (1 - P_DETECT) / (NPHOTONS * NEVENTS))
    assert abs(frac - P_DETECT) < 5 * sigma, (frac, P_DETECT, sigma)

    # time of flight: every detected photon arrives at R n / c, short
    # only by the facet sagitta of the triangulated sphere (a facet
    # spans ~pi/nsteps of arc, so the chord is at worst
    # R cos(pi/nsteps) ~ R (1 - 1.2e-3) from the center)
    t = np.concatenate(t_unsmeared)
    assert len(t) > 0.9 * P_DETECT * NPHOTONS * NEVENTS
    facet = 1.0 - np.cos(np.pi / SPHERE_NSTEPS)
    assert (t <= T0 * (1 + 1e-4)).all()
    assert (t >= T0 * (1 - 3 * facet)).all()
    np.testing.assert_allclose(np.mean(t), T0, rtol=2 * facet)


@pytest.mark.slow
def test_analytic_daq_time_and_charge(sphere_sim):
    gdet = sphere_sim.gpu_geometry.det
    ch_t, ch_q = [], []
    for ev in _events(sphere_sim):
        assert bool(np.asarray(ev.channels.hit)[0])
        ch_t.append(float(np.asarray(ev.channels.t)[0]))
        ch_q.append(float(np.asarray(ev.channels.q)[0]))

    m = P_DETECT * NPHOTONS   # expected hits per event

    # channel time = t0 + min of m draws from the time-smear table
    t_icdf = np.asarray(gdet.time_icdf)
    min_mean, min_var = _min_of_m_moments(t_icdf, m)
    expect_t = T0 + min_mean
    tol_t = 5 * np.sqrt(min_var / NEVENTS) + 0.05 * T_RMS
    assert abs(np.mean(ch_t) - expect_t) < tol_t, \
        (np.mean(ch_t), expect_t, tol_t)
    # sanity: the earliest of ~8000 draws sits deep in the lower tail
    assert np.mean(ch_t) < T0 - 2.0 * T_RMS

    # channel charge = sum of m one-PE draws (+-0.5 LSB quantization)
    q_mean, q_var = _table_moments(np.asarray(gdet.charge_icdf))
    expect_q = m * q_mean
    var_q = m * q_var + P_DETECT * (1 - P_DETECT) * NPHOTONS * q_mean ** 2
    tol_q = 5 * np.sqrt(var_q / NEVENTS) \
        + m * float(np.asarray(gdet.charge_unit))
    assert abs(np.mean(ch_q) - expect_q) < tol_q, \
        (np.mean(ch_q), expect_q, tol_q)
