"""Physics validation of the native TrackGenerator against analytic
expectations (Frank-Tamm yields, PDG ranges, Birks quenching,
scintillation time profiles) — the reference validates these through
Geant4; here they must hold by construction."""
import numpy as np
import pytest

from chroma_jax import event
from chroma_jax.demo.optics import water
from chroma_jax.generator.trackgen import (TrackGenerator, EMMedium,
                                           fabjan_fraction, ME)


def frank_tamm_per_mm(beta, ri_table):
    """Independent Frank-Tamm dN/dx over the refractive-index table."""
    ri = np.asarray(ri_table, float)
    lam = np.linspace(ri[:, 0].min(), ri[:, 0].max(), 2000)
    n = np.interp(lam, ri[:, 0], ri[:, 1])
    sin2 = np.maximum(1.0 - 1.0 / (beta * n) ** 2, 0.0)
    return 2 * np.pi / 137.035999 * 1e6 * np.trapezoid(sin2 / lam ** 2,
                                                       lam)


def test_frank_tamm_muon_segment():
    """Photon count in the first 50 cm of a 1 GeV muon track matches
    the Frank-Tamm integral at the local velocity within 10%."""
    gen = TrackGenerator(water, seed=11)
    v = event.Vertex('mu-', (0, 0, 0), (0, 0, 1), 1000.0)
    photons = gen.generate_photons([v])
    seg = 500.0
    count = int((photons.pos[:, 2] < seg).sum())

    # independent expectation: integrate dN/dx over the energy profile
    em = EMMedium(water)
    ke, x, expected = 1000.0, 0.0, 0.0
    while x < seg:
        dndx = frank_tamm_per_mm(
            np.sqrt(1 - 1 / (1 + ke / 105.6583755) ** 2),
            water.refractive_index)
        dx = min(10.0, seg - x)
        expected += dndx * dx
        ke -= float(em.heavy_dedx(ke, 105.6583755)) * dx
        x += dx
    assert abs(count - expected) / expected < 0.10


def test_cherenkov_cone_and_spectrum():
    """High-momentum proton: negligible MCS, so every photon sits on
    the cone cos(theta) = 1/(beta n(lambda)); spectrum ~ 1/lambda^2."""
    gen = TrackGenerator(water, seed=3)
    v = event.Vertex('proton', (0, 0, 0), (0, 0, 1), 2000.0)
    photons = gen.generate_photons([v])
    assert len(photons) > 5000
    # use the early track: beta ~ const, straight
    sel = photons.pos[:, 2] < 200.0
    ke_mid = 2000.0 - float(EMMedium(water).heavy_dedx(
        2000.0, 938.272)) * 100.0
    gamma = 1 + ke_mid / 938.272
    beta = np.sqrt(1 - 1 / gamma ** 2)
    ri = np.asarray(water.refractive_index, float)
    n_at = np.interp(photons.wavelengths[sel], ri[:, 0], ri[:, 1])
    cos_meas = photons.dir[sel, 2]
    assert np.abs(cos_meas - 1.0 / (beta * n_at)).mean() < 0.01

    # 1/lambda^2 band ratio (above-threshold lambdas only)
    wl = photons.wavelengths
    lo = ((wl > 250) & (wl < 350)).sum()
    hi = ((wl > 450) & (wl < 550)).sum()
    lam = np.linspace(200, 800, 1200)
    n = np.interp(lam, ri[:, 0], ri[:, 1])
    pdf = np.maximum(1 - 1 / (beta * n) ** 2, 0) / lam ** 2
    exp_lo = np.trapezoid(pdf[(lam > 250) & (lam < 350)],
                          lam[(lam > 250) & (lam < 350)])
    exp_hi = np.trapezoid(pdf[(lam > 450) & (lam < 550)],
                          lam[(lam > 450) & (lam < 550)])
    assert abs(lo / hi - exp_lo / exp_hi) / (exp_lo / exp_hi) < 0.1


def test_electron_shower_yield():
    """e- 100 MeV (shower regime): Cherenkov photons per MeV within 15%
    of the Frank-Tamm x above-threshold-track-length expectation built
    from PDG water constants (X0=36.08 g/cm^2, Ec~78.3 MeV)."""
    gen = TrackGenerator(water, seed=5)
    counts = []
    for i in range(8):
        v = event.Vertex('e-', (0, 0, 0), (0, 0, 1), 100.0)
        counts.append(len(gen.generate_photons([v])))
    measured = np.mean(counts)

    n_max = np.asarray(water.refractive_index, float)[:, 1].max()
    e_thresh = ME * (1 / np.sqrt(1 - 1 / n_max ** 2) - 1)
    z = 4.58 * e_thresh * 7.42 / (14.3 * 78.3)   # Zeff/Aeff water
    track_mm = fabjan_fraction(z) * (100.0 + ME) / 78.3 * 360.8
    expected = track_mm * frank_tamm_per_mm(1.0, water.refractive_index)
    assert abs(measured - expected) / expected < 0.15


def test_low_energy_electron_yield():
    """e- 5 MeV (stepping regime): yield matches an independent
    integral of Frank-Tamm over the CSDA energy profile within 10%."""
    gen = TrackGenerator(water, seed=7)
    counts = [len(gen.generate_photons(
        [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 5.0)]))
        for _ in range(60)]
    measured = np.mean(counts)

    em = EMMedium(water)
    ke, expected = 5.0, 0.0
    while ke > 0.21:
        dedx = float(em.electron_dedx_collision(ke)
                     + em.electron_dedx_radiative(ke))
        dx = min(0.02 * ke / dedx, 0.5)
        gamma = 1 + ke / ME
        beta = np.sqrt(1 - 1 / gamma ** 2)
        expected += frank_tamm_per_mm(beta, water.refractive_index) * dx
        ke -= dedx * dx
    assert abs(measured - expected) / expected < 0.10


def test_muon_range_pdg():
    """1 GeV muon range in water ~ 4.5 m (PDG CSDA)."""
    gen = TrackGenerator(water, seed=2)
    v = event.Vertex('mu-', (0, 0, 0), (0, 0, 1), 1000.0)
    gen.generate_photons([v])
    path = np.sum(np.sqrt(np.ediff1d(v.steps.x) ** 2
                          + np.ediff1d(v.steps.y) ** 2
                          + np.ediff1d(v.steps.z) ** 2))
    assert 4000.0 < path < 5100.0


def _scint_material(birks_mm=0.0):
    import copy
    mat = copy.deepcopy(water)
    lam = np.linspace(350.0, 450.0, 21)
    mat.scintillation_spectrum = np.column_stack(
        [lam, np.ones_like(lam)])
    mat.scintillation_light_yield = 100.0        # photons / MeV
    mat.scintillation_waveform = np.array([[-10.0, 1.0]])
    if birks_mm:
        mat.scintillation_mod = {'birks': birks_mm}
    return mat


def test_scintillation_yield_and_waveform():
    """Unquenched yield = light_yield x KE; delays ~ Exp(10 ns)
    (GLG4Scint.cc:280,384 behavior)."""
    mat = _scint_material()
    gen = TrackGenerator(mat, seed=9)
    v = event.Vertex('e-', (0, 0, 0), (0, 0, 1), 10.0)
    photons = gen.generate_photons([v])
    scint = photons.t[(photons.flags & event.SCINTILLATION) > 0]
    # ~ 100/MeV x 10 MeV, minus the few % radiated to child gammas of
    # which most still deposits
    assert 800 < len(scint) < 1100
    # subtract emission-time jitter (track is ~50 mm: < 0.2 ns)
    assert abs(np.mean(scint) - 10.0) < 1.0
    wl = photons.wavelengths[(photons.flags & event.SCINTILLATION) > 0]
    assert (wl >= 349.0).all() and (wl <= 451.0).all()


def test_birks_quenching():
    """A slow proton (high dE/dx) is quenched much harder than an
    electron at the same deposited energy (GLG4Scint.cc:264-269)."""
    mat = _scint_material(birks_mm=0.1)
    gen = TrackGenerator(mat, seed=13)
    n_e, n_p = [], []
    for i in range(5):
        ve = event.Vertex('e-', (0, 0, 0), (0, 0, 1), 5.0)
        ph = gen.generate_photons([ve])
        n_e.append(((ph.flags & event.SCINTILLATION) > 0).sum())
        vp = event.Vertex('proton', (0, 0, 0), (0, 0, 1), 5.0)
        ph = gen.generate_photons([vp])
        n_p.append(((ph.flags & event.SCINTILLATION) > 0).sum())
    # e- dE/dx ~ 0.2 MeV/mm -> ~2% quench; p 5 MeV ~ 8-13 MeV/mm ->
    # ~50% quench
    assert np.mean(n_p) < 0.65 * np.mean(n_e)
    assert np.mean(n_e) > 0.85 * 500.0
    # qedep recorded on the vertex steps
    assert vp.steps.qedep.sum() < 0.7 * vp.steps.edep.sum()


def test_gamma_conversion():
    """Gammas convert downstream and yield shower photons comparable
    to an electron of the same energy."""
    gen = TrackGenerator(water, seed=17)
    n_g = np.mean([len(gen.generate_photons(
        [event.Vertex('gamma', (0, 0, 0), (0, 0, 1), 50.0)]))
        for _ in range(8)])
    n_e = np.mean([len(gen.generate_photons(
        [event.Vertex('e-', (0, 0, 0), (0, 0, 1), 50.0)]))
        for _ in range(8)])
    assert 0.7 * n_e < n_g < 1.3 * n_e
    # conversion displaces the shower start downstream
    v = event.Vertex('gamma', (0, 0, 0), (0, 0, 1), 50.0)
    ph = gen.generate_photons([v])
    assert np.percentile(ph.pos[:, 2], 5) > 10.0


def test_scintillate_step_matches_model():
    """The per-step sampler the Geant4 stepping action drives
    (g4gen._SteppingAction) reproduces ScintillationModel semantics:
    Poisson yield on the quenched deposit, uniform emission along the
    step, waveform delays (reference src/GLG4Scint.cc:264-386)."""
    from chroma_jax.generator.trackgen import (ScintillationModel,
                                               scintillate_step)
    mat = _scint_material(birks_mm=0.1)
    model = ScintillationModel(mat)
    rng = np.random.RandomState(3)
    # 2 MeV over a 10 mm step -> dE/dx 0.2 MeV/mm, quench 1/(1+0.02)
    qs, counts, ts, zs = [], [], [], []
    for _ in range(200):
        qedep, ph = scintillate_step(
            model, rng, (0, 0, 0), (0, 0, 10.0), 5.0, 5.1, 2.0)
        qs.append(qedep)
        counts.append(0 if ph is None else len(ph))
        if ph is not None:
            ts.append(ph.t)
            zs.append(ph.pos[:, 2])
    assert abs(qs[0] - 2.0 / 1.02) < 1e-9
    assert abs(np.mean(counts) - 100.0 * 2.0 / 1.02) < 10.0
    t = np.concatenate(ts)
    z = np.concatenate(zs)
    # delays ~ Exp(10 ns) on top of t in [5.0, 5.1]
    assert abs(np.mean(t) - (5.05 + 10.0)) < 1.0
    # uniform along the step
    assert (z >= 0.0).all() and (z <= 10.0).all()
    assert abs(np.mean(z) - 5.0) < 0.5
    wl = np.concatenate([np.asarray(p) for p in
                         (ph.wavelengths,)])  # spectrum bounds
    assert (wl >= 349.0).all() and (wl <= 451.0).all()
    # zero deposit -> nothing
    q0, p0 = scintillate_step(model, rng, (0, 0, 0), (0, 0, 1.0),
                              0.0, 0.1, 0.0)
    assert q0 == 0.0 and p0 is None


def test_stub_is_gone():
    """g4gen raises ImportError (not NotImplementedError) without
    Geant4, so the pool falls back to TrackGenerator."""
    with pytest.raises(ImportError):
        from chroma_jax.generator.g4gen import G4Generator  # noqa: F401
