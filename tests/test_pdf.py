"""Distribution-level validation of the PDF estimators (ops/pdf.py)
against known densities, driven by synthetic channel readouts.

The reference's variable-bin estimator (chroma/cuda/pdf.cu:152,
accumulate_bincount + accumulate_nearest_neighbor_block) switches
between a fixed-window count and a k-nearest-neighbor density; both
branches are checked here against the analytic value of a Gaussian
hit-time density, at two ``min_bin_content`` settings.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax.numpy as jnp

from chroma_jax.ops.pdf import GPUPDF, GPUKernelPDF

TRANGE = (-50.0, 150.0)
SIGMA = np.array([4.0, 6.0, 3.0, 5.0], dtype=np.float32)
MU = np.array([40.0, 55.0, 70.0, 30.0], dtype=np.float32)
# evaluation points at the peak, 1 sigma, ~1.5 sigma, 2 sigma
EVT = MU + np.array([0.0, 1.0, -1.5, 2.0], np.float32) * SIGMA
NCH = 4


class FakeChannels(object):
    """Stand-in for ops/daq.py channel readouts: (ndaq * nchannels,)
    flat time/charge arrays."""

    def __init__(self, t, q, ndaq):
        self.t = jnp.asarray(t, jnp.float32)
        self.q = jnp.asarray(q, jnp.float32)
        self.ndaq = ndaq


def gaussian_batches(nsamples, ndaq, seed):
    """Yield FakeChannels batches whose per-channel hit times are
    N(MU, SIGMA); total samples per channel = nsamples."""
    rng = np.random.RandomState(seed)
    done = 0
    while done < nsamples:
        n = min(ndaq, nsamples - done)
        t = rng.normal(MU, SIGMA, size=(n, NCH)).astype(np.float32)
        q = np.ones((n, NCH), np.float32)
        yield FakeChannels(t.ravel(), q.ravel(), n)
        done += n


def analytic_density(i):
    """Gaussian density at EVT[i], normalized to the TRANGE window
    (the estimator conditions on hits inside trange)."""
    from math import erf, sqrt
    z = (EVT[i] - MU[i]) / SIGMA[i]
    base = np.exp(-0.5 * z * z) / (SIGMA[i] * np.sqrt(2 * np.pi))
    lo = 0.5 * (1 + erf((TRANGE[0] - MU[i]) / (SIGMA[i] * sqrt(2))))
    hi = 0.5 * (1 + erf((TRANGE[1] - MU[i]) / (SIGMA[i] * sqrt(2))))
    return base / (hi - lo)


def run_eval(min_twidth, min_bin_content, nsamples=100000, seed=7):
    pdf = GPUPDF()
    pdf.setup_pdf_eval(np.ones(NCH, bool), EVT, np.ones(NCH, np.float32),
                       min_twidth, TRANGE, 1.0, (0.0, 10.0),
                       min_bin_content=min_bin_content, time_only=True)
    for batch in gaussian_batches(nsamples, 4096, seed):
        pdf.accumulate_pdf_eval(batch)
    return pdf.get_pdf_eval()


@pytest.mark.slow
def test_nn_estimator_low_stats_branch():
    """With a tiny fixed window the estimator must fall back to the
    k-NN branch (pdf.cu:152) and converge to the analytic density:
    bias within the estimator's own reported uncertainty band."""
    hitcount, value, uncert = run_eval(min_twidth=1e-4,
                                       min_bin_content=20)
    assert (hitcount > 90000).all()
    for i in range(NCH):
        expect = analytic_density(i)
        # k-NN branch reports 1/sqrt(k) fractional uncertainty
        assert uncert[i] > 0
        assert abs(value[i] - expect) < 3 * uncert[i], \
            (i, value[i], expect, uncert[i])
        # and the k-NN estimate must actually be tight: k/n bias is
        # negligible at n=1e5, so 25% accuracy is guaranteed
        assert abs(value[i] - expect) / expect < 0.25


@pytest.mark.slow
def test_nn_estimator_high_stats_branch():
    """With a window wide enough to hold >= min_bin_content samples
    the estimator must use the direct count (bincount/hitcount/width)
    and match the analytic density within combined binning bias and
    Poisson error."""
    hitcount, value, uncert = run_eval(min_twidth=1.0,
                                       min_bin_content=20)
    for i in range(NCH):
        expect = analytic_density(i)
        # binning bias over a 1ns window at sigma>=3ns is < 1%
        assert abs(value[i] - expect) < 3 * uncert[i] + 0.01 * expect, \
            (i, value[i], expect, uncert[i])


@pytest.mark.slow
def test_nn_estimator_converges_with_k():
    """Doubling min_bin_content must shrink the k-NN branch's reported
    uncertainty (1/sqrt(k)) while staying consistent with the analytic
    density — the 'bias < stat error at two settings' check."""
    _, v1, u1 = run_eval(min_twidth=1e-4, min_bin_content=10, seed=11)
    _, v2, u2 = run_eval(min_twidth=1e-4, min_bin_content=40, seed=11)
    for i in range(NCH):
        expect = analytic_density(i)
        assert u2[i] < u1[i]
        assert abs(v1[i] - expect) < 3 * u1[i]
        assert abs(v2[i] - expect) < 3 * u2[i]


@pytest.mark.slow
def test_kernel_pdf_matches_analytic():
    """GPUKernelPDF (moments -> Silverman bandwidth -> erf-normalized
    KDE, reference chroma/gpu/pdf.py:61 + cuda/pdf.cu
    accumulate_kernel_eval) must reproduce the analytic density at the
    event point, accounting for its own smoothing: the reference's
    Silverman variant (missing square in the exponent, bandwidth
    GROWING with hitcount) intentionally oversmooths, so the correct
    expectation is the Gaussian convolved with the kernel at the
    bandwidth the estimator itself computed —
    N(evt; mu, sqrt(sigma^2 + bw^2)) — not the raw density.

    The kernel accumulators consume ONE readout per call
    (t[:nchannels]); to batch samples, each logical channel is tiled R
    times and the per-tile KDE averages are recombined weighted by
    hitcount."""
    R = 512
    mu_b = np.tile(MU, R)
    sig_b = np.tile(SIGMA, R)
    evt_b = np.tile(EVT, R)
    nchb = NCH * R
    rng = np.random.RandomState(3)

    def batches(ncalls, rng):
        for _ in range(ncalls):
            t = rng.normal(mu_b, sig_b).astype(np.float32)
            yield FakeChannels(t, np.ones(nchb, np.float32), 1)

    kpdf = GPUKernelPDF()
    kpdf.setup_moments(nchb, TRANGE, (0.0, 10.0), time_only=True)
    for batch in batches(40, rng):
        kpdf.accumulate_moments(batch)
    kpdf.compute_bandwidth(np.ones(nchb, bool), evt_b,
                           np.ones(nchb, np.float32))
    kpdf.setup_kernel(np.ones(nchb, bool), evt_b,
                      np.ones(nchb, np.float32))
    for batch in batches(40, rng):
        kpdf.accumulate_kernel(batch)
    hitcount, value, _ = kpdf.get_kernel_eval()
    assert (hitcount >= 35).all()
    bw = np.asarray(kpdf.inv_time_bandwidths)
    bw = np.where(bw > 0, 1.0 / np.maximum(bw, 1e-30), 0.0)
    for i in range(NCH):
        hc = hitcount[i::NCH].astype(float)
        combined = float(np.sum(value[i::NCH] * hc) / np.sum(hc))
        # expectation per tile: E_t[K_bw(evt - t) / W(t)] with t ~
        # N(mu, sigma) and W(t) the kernel's erf normalization over the
        # PDF window (the bandwidth here is a sizable fraction of the
        # window, so truncation matters); hitcount-weighted like the
        # estimate
        from scipy.stats import norm as gauss
        tg = np.linspace(MU[i] - 8 * SIGMA[i], MU[i] + 8 * SIGMA[i],
                         4001)
        ft = gauss.pdf(tg, MU[i], SIGMA[i])
        per_tile = []
        for b in bw[i::NCH]:
            kern = gauss.pdf(EVT[i], tg, b)
            W = gauss.cdf((TRANGE[1] - tg) / b) \
                - gauss.cdf((TRANGE[0] - tg) / b)
            per_tile.append(np.trapezoid(ft * kern / W, tg))
        expect = float(np.sum(np.asarray(per_tile) * hc) / np.sum(hc))
        assert abs(combined - expect) / expect < 0.05, \
            (i, combined, expect)
        # sanity: smoothing only ever flattens the true density's peak
        if EVT[i] == MU[i]:
            assert combined < analytic_density(i)


@pytest.mark.slow
def test_eval_pdf_accepts_bare_photons():
    """Simulation.eval_pdf / create_pdf given a bare Photons bundle
    must treat it as ONE event, like simulate() does.  (Regression:
    iterating the bundle directly split it into single-photon events
    via Photons.__getitem__, whose scalar fields then crashed the
    GPUPhotons padding — found by tools/bench_suite.py pdf_eval.)"""
    from chroma_jax import demo
    from chroma_jax.sim import Simulation
    from chroma_jax.generator.photon import photon_bomb

    sim = Simulation(demo.tiny(), geant4_processes=0, seed=5)
    bomb = photon_bomb(400, 400.0, (0.0, 0.0, 0.0)).photons_beg
    ev0 = next(sim.simulate(bomb, run_daq=True))

    hitcount, pdf = sim.create_pdf(bomb, 16, (-0.5, 99.5), 4,
                                   (-0.5, 9.5))
    assert hitcount.sum() > 0          # one event's worth of hits

    hitcount2, pdf_value, pdf_err = sim.eval_pdf(
        ev0.channels,
        photon_bomb(400, 400.0, (0.0, 0.0, 0.0)).photons_beg,
        1.0, (-0.5, 99.5), 1.0, (-0.5, 9.5),
        nreps=2, ndaq=4, min_bin_content=5)
    assert np.isfinite(np.asarray(pdf_value)).all()
    assert np.asarray(hitcount2).sum() > 0
