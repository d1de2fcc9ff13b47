"""Propagation physics: statistical ports of the reference tests
(reference: test/test_propagation.py, test_rayleigh.py,
test_reemission.py) plus Fresnel/surface checks the reference lacked.
All run on the CPU backend with modest photon counts."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from chroma_jax import event, make
from chroma_jax.geometry import Solid, Geometry, Surface, Material, vacuum
from chroma_jax.demo.optics import water
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.ops.geometry_pack import pack_geometry
from chroma_jax.ops import photon as gpu_photon


def run(geom, photons, key=0, max_steps=10, **kw):
    state = gpu_photon.upload_photons(photons)
    out, steps = gpu_photon.propagate(state, geom,
                                      jax.random.PRNGKey(key),
                                      max_steps=max_steps, **kw)
    out = gpu_photon.unsort_photons(out)  # restore upload order
    return gpu_photon.download_photons(out)


def axis_photons(n, wavelength=400.0):
    pos = np.zeros((n, 3), dtype=np.float32)
    dir = np.tile([0, 0, 1], (n, 1)).astype(np.float32)
    phi = np.random.RandomState(5).uniform(0, 2 * np.pi, n)
    pol = np.zeros_like(pos)
    pol[:, 0] = np.cos(phi)
    pol[:, 1] = np.sin(phi)
    return event.Photons(pos=pos, dir=dir, pol=pol,
                         wavelengths=np.full(n, wavelength, np.float32))


@pytest.fixture(scope='module')
def vacuum_box():
    cube = Geometry(vacuum)
    cube.add_solid(Solid(make.box(100, 100, 100), vacuum, vacuum))
    geo = create_geometry_from_obj(cube, update_bvh_cache=False)
    return pack_geometry(geo)


@pytest.fixture(scope='module')
def water_box():
    cube = Geometry(water)
    cube.add_solid(Solid(make.box(100, 100, 100), water, water))
    geo = create_geometry_from_obj(cube, update_bvh_cache=False)
    return pack_geometry(geo)


@pytest.mark.slow
def test_abort(vacuum_box):
    """Normal-incidence photons must never NaN-abort (reference:
    test_propagation.py testAbort)."""
    photons = axis_photons(2000)
    p1 = run(vacuum_box, photons, max_steps=1)
    for arr in (p1.pos, p1.dir, p1.pol, p1.t, p1.wavelengths):
        assert not np.isnan(arr).any()
    p10 = run(vacuum_box, photons, max_steps=10)
    aborted = (p10.flags & event.NAN_ABORT) > 0
    assert not aborted.any()


def test_all_terminate_in_vacuum_box(vacuum_box):
    """In a surface-less vacuum box every photon eventually leaves
    (NO_HIT) — and the time of flight matches the geometry."""
    photons = axis_photons(500)
    p = run(vacuum_box, photons, max_steps=10)
    assert ((p.flags & event.NO_HIT) > 0).all()


def test_time_of_flight(water_box):
    """Photon time accumulates distance * n / c (photon.h:236)."""
    photons = axis_photons(100)
    p = run(water_box, photons, max_steps=1)
    # first wall at z=50mm; n(400nm) in our water model
    from chroma_jax.demo.optics import water_refractive_index
    n = water_refractive_index(400.0)
    # photons that made it to the wall without scattering/absorbing
    straight = (p.flags & (event.RAYLEIGH_SCATTER | event.BULK_ABSORB)) == 0
    assert straight.sum() > 50
    np.testing.assert_allclose(p.t[straight], 50.0 * n / 299.792458,
                               rtol=1e-4)


@pytest.fixture(scope='module')
def scatter_box():
    scatterer = Material('scatterer')
    scatterer.set('refractive_index', 1.33)
    scatterer.set('absorption_length', 1e9)
    scatterer.set('scattering_length', 50.0)  # mm: most photons scatter
    cube = Geometry(scatterer)
    cube.add_solid(Solid(make.box(100, 100, 100), scatterer, scatterer))
    geo = create_geometry_from_obj(cube, update_bvh_cache=False)
    return pack_geometry(geo)


@pytest.mark.slow
def test_rayleigh_angular_distribution(scatter_box):
    """Polarized Rayleigh scattering follows (1+cos^2) (reference:
    test_rayleigh.py, GEANT4 physics reference manual)."""
    n = 40000
    photons = axis_photons(n)
    photons.pol[:] = [1.0, 0.0, 0.0]
    p = run(scatter_box, photons, max_steps=1, key=3)
    scattered = (p.flags & event.RAYLEIGH_SCATTER) > 0
    assert scattered.sum() > 500
    cos_scatter = (photons.dir[scattered] * p.dir[scattered]).sum(axis=1)
    # chi^2 against the analytic density rho(c) = 3/8 (1 + c^2)
    hist, edges = np.histogram(cos_scatter, bins=20, range=(-1, 1))
    centers = 0.5 * (edges[1:] + edges[:-1])
    expected = 3.0 / 8.0 * (1 + centers ** 2)
    expected = expected / expected.sum() * hist.sum()
    chi2 = ((hist - expected) ** 2 / expected).sum()
    # 20 bins, ~19 dof: chi2 beyond ~45 is p < 1e-3
    assert chi2 < 45.0, chi2


@pytest.mark.slow
def test_bulk_reemission_spectrum():
    """Wavelength-shifted photons follow the reemission CDF (reference:
    test_reemission.py testBulkReemission)."""
    from scipy import stats as sstats

    # NOTE: the reference test (skipped there) uses a 1 mm absorption
    # length inside a 500 mm sphere, which needs ~1e5 random-walk steps
    # to escape; we use parameters that terminate in a few steps.
    scint = Material('scint')
    scint.set('refractive_index', 1.0)
    scint.set('absorption_length', 200.0)
    scint.set('scattering_length', 1e7)
    x = np.arange(0, 1000, 10.0)
    cdf = sstats.norm(scale=50, loc=600).cdf(x)
    scint.add_reemission_component(
        reemission_prob=np.column_stack([x, np.ones_like(x)]),
        wvl_cdf=np.column_stack([x, cdf]))

    detector_surf = Surface('detector')
    detector_surf.set('detect', 1)

    world = Geometry(vacuum)
    world.add_solid(Solid(make.sphere(1000, nsteps=32), vacuum, vacuum,
                          surface=detector_surf))
    world.add_solid(Solid(make.sphere(100, nsteps=32), scint, vacuum))
    geo = create_geometry_from_obj(world, update_bvh_cache=False)
    geom = pack_geometry(geo)

    n = 20000
    rng = np.random.RandomState(0)
    dir = rng.normal(size=(n, 3)).astype(np.float32)
    dir /= np.linalg.norm(dir, axis=1)[:, None]
    photons = event.Photons(pos=np.zeros((n, 3), np.float32), dir=dir,
                            pol=np.cross(rng.normal(size=(n, 3)), dir),
                            wavelengths=np.full(n, 250.0, np.float32))
    p = run(geom, photons, max_steps=20, key=7)
    detected = (p.flags & event.SURFACE_DETECT) > 0
    reemitted = (p.flags & event.BULK_REEMIT) > 0
    assert (reemitted & detected).sum() > 2000
    wl = p.wavelengths[detected & reemitted]
    # KS test against the normal reemission spectrum
    ks = sstats.kstest(wl, sstats.norm(scale=50, loc=600).cdf)
    assert ks.pvalue > 1e-3, ks


@pytest.mark.slow
def test_fresnel_normal_incidence():
    """Reflectance at normal incidence = ((n1-n2)/(n1+n2))^2 = 4%
    for n2=1.5 (photon.h:310)."""
    glass = Material('glassy')
    glass.set('refractive_index', 1.5)
    glass.set('absorption_length', 1e-3)  # absorb as soon as inside
    glass.set('scattering_length', 1e9)

    world = Geometry(vacuum)
    world.add_solid(Solid(make.box(1000, 1000, 1000), vacuum, vacuum))
    world.add_solid(Solid(make.box(100, 100, 100), glass, vacuum,
                          color=0xff0000), displacement=(0, 0, 200))
    geo = create_geometry_from_obj(world, update_bvh_cache=False)
    geom = pack_geometry(geo)

    n = 20000
    photons = axis_photons(n)
    p = run(geom, photons, max_steps=3, key=11)
    reflected = (p.flags & event.REFLECT_SPECULAR) > 0
    frac = reflected.mean()
    expect = ((1.0 - 1.5) / (1.0 + 1.5)) ** 2
    assert abs(frac - expect) < 0.01, (frac, expect)


@pytest.mark.slow
def test_default_surface_outcomes():
    """DEFAULT surface model outcome fractions (photon.h:684)."""
    surf = Surface('mixed')
    surf.set('detect', 0.2)
    surf.set('absorb', 0.3)
    surf.set('reflect_diffuse', 0.4)
    surf.set('reflect_specular', 0.1)

    world = Geometry(vacuum)
    world.add_solid(Solid(make.box(100, 100, 100), vacuum, vacuum,
                          surface=surf))
    geo = create_geometry_from_obj(world, update_bvh_cache=False)
    geom = pack_geometry(geo)

    n = 20000
    photons = axis_photons(n)
    p = run(geom, photons, max_steps=1, key=13)
    frac = lambda bit: ((p.flags & bit) > 0).mean()
    assert abs(frac(event.SURFACE_DETECT) - 0.2) < 0.02
    assert abs(frac(event.SURFACE_ABSORB) - 0.3) < 0.02
    assert abs(frac(event.REFLECT_DIFFUSE) - 0.4) < 0.02
    assert abs(frac(event.REFLECT_SPECULAR) - 0.1) < 0.02


def test_diffuse_reflection_cosine():
    """Diffuse reflections are cosine-weighted about the normal."""
    surf = Surface('white')
    surf.set('reflect_diffuse', 1.0)
    world = Geometry(vacuum)
    world.add_solid(Solid(make.box(100, 100, 100), vacuum, vacuum,
                          surface=surf))
    geo = create_geometry_from_obj(world, update_bvh_cache=False)
    geom = pack_geometry(geo)

    n = 20000
    photons = axis_photons(n)
    p = run(geom, photons, max_steps=1, key=17)
    refl = (p.flags & event.REFLECT_DIFFUSE) > 0
    assert refl.sum() > n * 0.95
    # photons hit +z wall; reflected direction z-component ~ -cos
    cosr = -p.dir[refl][:, 2]
    assert (cosr > 0).all()
    # cosine-weighted: E[cos] = 2/3
    assert abs(cosr.mean() - 2.0 / 3.0) < 0.01


@pytest.mark.slow
def test_photon_order_preserved(water_box):
    """photons_end[i] must correspond to photons_beg[i] despite the
    compaction sorts (regression: the Morton sort permuted the batch)."""
    from chroma_jax import gpu
    n = 4096
    photons = axis_photons(n)
    # unique wavelength per photon survives propagation (no reemission)
    photons.wavelengths[:] = np.linspace(200.0, 800.0, n,
                                         dtype=np.float32)
    gp = gpu.GPUPhotons(photons)
    gp.propagate(type('G', (), {'geom': water_box})(),
                 gpu.get_rng_states(seed=3), max_steps=20)
    out = gp.get()
    np.testing.assert_array_equal(out.wavelengths, photons.wavelengths)


def test_nan_photons_abort(vacuum_box):
    """NaN directions must terminate with NAN_ABORT | NO_HIT
    (regression: flags were computed but never written back)."""
    photons = axis_photons(64)
    photons.dir[0] = np.nan
    p = run(vacuum_box, photons, max_steps=10)
    assert p.flags[0] & event.NAN_ABORT
    assert p.flags[0] & event.NO_HIT
    # the rest are unaffected
    assert ((p.flags[1:] & event.NO_HIT) > 0).all()
    assert not ((p.flags[1:] & event.NAN_ABORT) > 0).any()


@pytest.mark.slow
def test_fused_matches_compacting_statistically(water_box):
    """The fused megakernel driver (ops/fused.py) and the host-driven
    compacting driver must sample identical physics: compare terminal
    flag rates and arrival-time moments on a water box."""
    import jax
    from chroma_jax.ops.fused import propagate_fused

    n = 6000
    rng = np.random.RandomState(11)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    photons = event.Photons(pos=np.zeros((n, 3), np.float32), dir=dirs,
                            pol=pol,
                            wavelengths=np.full(n, 400.0, np.float32))

    state = gpu_photon.upload_photons(photons)
    out_c, _ = gpu_photon.propagate(state, water_box,
                                    jax.random.PRNGKey(5), max_steps=20)
    out_c = gpu_photon.unsort_photons(out_c)
    pc = gpu_photon.download_photons(out_c)

    state = gpu_photon.upload_photons(photons)
    out_f, _ = propagate_fused(state, water_box, jax.random.PRNGKey(6),
                               max_steps=20, width=2048)
    pf = gpu_photon.download_photons(out_f)

    # the fused pool writes results back to original slots: order kept
    np.testing.assert_array_equal(pf.wavelengths, photons.wavelengths)

    for flag in (event.NO_HIT, event.RAYLEIGH_SCATTER,
                 event.REFLECT_SPECULAR):
        rc = ((pc.flags & flag) != 0).mean()
        rf = ((pf.flags & flag) != 0).mean()
        err = 3 * np.sqrt(max(rc * (1 - rc), 1e-4) / n) * 2
        assert abs(rc - rf) < err + 0.01, (flag, rc, rf)
    assert abs(pc.t.mean() - pf.t.mean()) < 0.1 * pc.t.std() + 1e-3


def test_propagate_fused_has_one_walker():
    """The fused driver runs the jnp MBVH walker on every backend: the
    per-platform walker choice and its on-deck options are gone."""
    import inspect
    from chroma_jax.ops import fused
    params = inspect.signature(fused._propagate_fused_packed).parameters
    for name in ('use_pallas', 'ondeck', 'od_slots', 'collect_stats'):
        assert name not in params
    assert not hasattr(fused, '_use_pallas_default')
    assert not hasattr(fused, '_service_ondeck')


def test_thin_film_transfer_matrix():
    """Validate the thin-film PMT window optics (ops/propagate.py
    thin_film_rta, reference: chroma/cuda/photon.h:400) against an
    independent complex128 solution of the three-layer boundary-value
    problem: match plane waves at both film interfaces and compare
    the physical R/T (power) coefficients for s and p polarization.
    Covers oblique incidence, absorbing films, interference
    thickness ranges, and total internal reflection at the exit."""
    from chroma_jax.ops.propagate import thin_film_rta

    def bvp_rt(n1, n2, n3, cos1, wl_nm, d_nm):
        """(Rs, Ts, Rp, Tp) from first principles, complex128."""
        n1, n2, n3 = complex(n1), complex(n2), complex(n3)
        k0 = 2.0 * np.pi / wl_nm
        sin1 = np.sqrt(1.0 - cos1 ** 2)
        kx = k0 * (n1 * sin1).real
        kz = []
        for n in (n1, n2, n3):
            k2 = (k0 * n) ** 2 - kx ** 2
            kzj = np.sqrt(k2 + 0j)
            if kzj.imag < 0:        # decaying branch
                kzj = -kzj
            kz.append(kzj)
        k1, k2z, k3 = kz
        out = []
        for pol in ('s', 'p'):
            # s: continuity of E, dE/dz; p (H formulation): continuity
            # of H, (1/n^2) dH/dz
            w = (1.0, 1.0, 1.0) if pol == 's' else \
                (1.0 / n1 ** 2, 1.0 / n2 ** 2, 1.0 / n3 ** 2)
            ph = np.exp(1j * k2z * d_nm)
            # unknowns x = (r, A, B, t)
            M = np.array([
                [-1.0, 1.0, 1.0, 0.0],
                [w[0] * k1, w[1] * k2z, -w[1] * k2z, 0.0],
                [0.0, ph, 1.0 / ph, -1.0],
                [0.0, w[1] * k2z * ph, -w[1] * k2z / ph, -w[2] * k3],
            ], dtype=np.complex128)
            b = np.array([1.0, w[0] * k1, 0.0, 0.0], np.complex128)
            r, A, B, t = np.linalg.solve(M, b)
            R = abs(r) ** 2
            T = (w[2] * k3).real / (w[0] * k1).real * abs(t) ** 2
            out.extend([R, T])
        return out  # Rs, Ts, Rp, Tp

    cases = []
    for n1, n2, n3 in [(1.33, 2.7 + 1.5j, 1.49),
                       (1.0, 1.5 + 0.1j, 1.33),
                       (1.49, 3.5 + 0.5j, 1.0),   # exit TIR region
                       (1.33, 1.9 + 0.0j, 1.33)]:  # lossless film
        for cos1 in (1.0, 0.9, 0.6, 0.3, 0.1):
            for wl in (300.0, 400.0, 600.0):
                for d_nm in (10.0, 30.0, 120.0):
                    cases.append((n1, n2, n3, cos1, wl, d_nm))

    n1a = jnp.asarray([c[0] for c in cases], jnp.float32)
    eta = jnp.asarray([c[1].real for c in cases], jnp.float32)
    kk = jnp.asarray([c[1].imag for c in cases], jnp.float32)
    n3a = jnp.asarray([c[2] for c in cases], jnp.float32)
    cosa = jnp.asarray([c[3] for c in cases], jnp.float32)
    wla = jnp.asarray([c[4] for c in cases], jnp.float32)
    tha = jnp.asarray([c[5] * 1e-6 for c in cases], jnp.float32)  # nm->mm

    s_r, s_t, p_r, p_t, n_r, n_t = thin_film_rta(
        n1a, eta, kk, n3a, cosa, wla, tha)
    got = np.stack([np.asarray(s_r), np.asarray(s_t),
                    np.asarray(p_r), np.asarray(p_t)], axis=1)
    want = np.array([bvp_rt(*c) for c in cases])

    np.testing.assert_allclose(got, want, atol=2e-3, rtol=2e-3)
    # R + T + A = 1 with A >= 0 (film absorbs, never amplifies)
    absorb = 1.0 - got[:, 0] - got[:, 1]
    assert absorb.min() > -2e-3
    absorb_p = 1.0 - got[:, 2] - got[:, 3]
    assert absorb_p.min() > -2e-3
    # normal-incidence channel == the oblique channel at cos1 == 1
    at_norm = np.isclose([c[3] for c in cases], 1.0)
    np.testing.assert_allclose(np.asarray(n_r)[at_norm],
                               got[at_norm, 0], atol=2e-3)
    np.testing.assert_allclose(np.asarray(n_t)[at_norm],
                               got[at_norm, 1], atol=2e-3)


def test_fused_dynamic_service(water_box):
    """The dynamic service cadence (service_frac: physics pass fires
    under lax.cond once enough lanes drain) must terminate every
    photon, preserve pool order, and sample the same physics as the
    static cadence."""
    from chroma_jax.ops.fused import propagate_fused

    n = 6000
    rng = np.random.RandomState(13)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    photons = event.Photons(pos=np.zeros((n, 3), np.float32), dir=dirs,
                            pol=pol,
                            wavelengths=np.full(n, 400.0, np.float32))

    state = gpu_photon.upload_photons(photons)
    out_s, stats_s = propagate_fused(state, water_box,
                                     jax.random.PRNGKey(6),
                                     max_steps=20, width=2048)
    ps = gpu_photon.download_photons(out_s)

    state = gpu_photon.upload_photons(photons)
    out_d, stats_d = propagate_fused(state, water_box,
                                     jax.random.PRNGKey(6),
                                     max_steps=20, width=2048,
                                     service_frac=0.25)
    pd = gpu_photon.download_photons(out_d)

    # order kept, all photons reach a terminal state
    np.testing.assert_array_equal(pd.wavelengths, photons.wavelengths)
    assert ((pd.flags & event.TERMINAL_FLAGS) != 0).all()
    # the dynamic cadence services when lanes drain, so it should not
    # run MORE physics passes than one-per-six-iterations
    assert int(stats_d[0]) <= int(stats_s[0]) * 2

    for flag in (event.NO_HIT, event.RAYLEIGH_SCATTER,
                 event.REFLECT_SPECULAR):
        rs = ((ps.flags & flag) != 0).mean()
        rd = ((pd.flags & flag) != 0).mean()
        err = 3 * np.sqrt(max(rs * (1 - rs), 1e-4) / n) * 2
        assert abs(rs - rd) < err + 0.01, (flag, rs, rd)
    assert abs(ps.t.mean() - pd.t.mean()) < 0.1 * ps.t.std() + 1e-3


@pytest.mark.slow
def test_fused_chains_uneven_segments(water_box, monkeypatch):
    """Multi-chain fused driver with a photon count NOT divisible by
    the chain count: pool segments differ by one, drain compaction
    kicks in, and the merged service pass handles per-chain widths.
    (Regression: chains=3 with n % 3 != 0 gives the chains ragged
    lane widths; the physics must simply match single-chain.)"""
    import jax
    from chroma_jax.ops import fused as F

    monkeypatch.setattr(F, 'MIN_CHAIN_WIDTH', 128)
    n = 2000   # 2000 % 3 != 0
    rng = np.random.RandomState(3)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    photons = event.Photons(pos=np.zeros((n, 3), np.float32), dir=dirs,
                            pol=pol,
                            wavelengths=np.full(n, 400.0, np.float32))

    state = gpu_photon.upload_photons(photons)
    out1, _ = F.propagate_fused(state, water_box, jax.random.PRNGKey(7),
                                max_steps=20, width=768, chains=1)
    p1 = gpu_photon.download_photons(out1)

    state = gpu_photon.upload_photons(photons)
    out3, _ = F.propagate_fused(state, water_box, jax.random.PRNGKey(8),
                                max_steps=20, width=768, chains=3)
    p3 = gpu_photon.download_photons(out3)

    # slot order preserved; every photon terminated either way
    np.testing.assert_array_equal(p3.wavelengths, photons.wavelengths)
    term = jnp.uint32(event.TERMINAL_FLAGS)
    assert ((p1.flags & term) != 0).all()
    assert ((p3.flags & term) != 0).all()
    # identical physics, different RNG pairing: flag rates must agree
    for flag in (event.NO_HIT, event.BULK_ABSORB,
                 event.RAYLEIGH_SCATTER):
        r1 = ((p1.flags & flag) != 0).mean()
        r3 = ((p3.flags & flag) != 0).mean()
        sigma = np.sqrt(max(r1 * (1 - r1), 1e-6) / n) * 2
        assert abs(r1 - r3) < 4 * sigma + 0.02, (flag, r1, r3)


@pytest.fixture(scope='module')
def murky_counter_box():
    """Scattering + absorbing medium with a pure counter wall
    (detect + absorb = 1, no reflection) — the configuration where the
    reference's weighted surface estimator (photon.h:672-733, forced
    detection with weight *= detect) is exactly unbiased, so weighted
    and unweighted detection estimates must agree."""
    med = Material('murky')
    med.set('refractive_index', 1.33)
    med.set('absorption_length', 150.0)
    med.set('scattering_length', 100.0)
    counter = Surface('counter')
    counter.set('detect', 0.3)
    counter.set('absorb', 0.7)
    cube = Geometry(med)
    cube.add_solid(Solid(make.box(100, 100, 100), med, med,
                         surface=counter))
    geo = create_geometry_from_obj(cube, update_bvh_cache=False)
    return pack_geometry(geo)


def _isotropic(n, seed):
    rng = np.random.RandomState(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    return event.Photons(pos=np.zeros((n, 3), np.float32), dir=dirs,
                         pol=pol,
                         wavelengths=np.full(n, 400.0, np.float32))


@pytest.mark.slow
def test_weighted_matches_unweighted(murky_counter_box):
    """Variance-reduced propagation (use_weights: bulk absorption
    prevented, weight *= exp(-d/abs_len); surface detection forced,
    weight *= detect — reference photon.h:205-232, 672-733) must give
    the same expected detection count as brute-force MC."""
    n = 30000
    photons = _isotropic(n, 21)

    p_mc = run(murky_counter_box, photons, key=100, max_steps=30)
    det_mc = ((p_mc.flags & event.SURFACE_DETECT) != 0)
    est_mc = det_mc.mean()
    sig_mc = np.sqrt(est_mc * (1 - est_mc) / n)

    p_w = run(murky_counter_box, photons, key=200, max_steps=30,
              use_weights=True)
    det_w = ((p_w.flags & event.SURFACE_DETECT) != 0)
    est_w = float(np.sum(p_w.weights * det_w) / n)
    # weighted detections carry fractional weights
    assert det_w.sum() > det_mc.sum()
    assert (p_w.weights[det_w] < 1.0).all()
    sig_w = float(np.sqrt(np.var(p_w.weights * det_w) / n))
    # the weighted estimator must be the lower-variance one
    assert sig_w < sig_mc
    assert abs(est_w - est_mc) < 4 * np.hypot(sig_mc, sig_w), \
        (est_w, est_mc, sig_mc, sig_w)


@pytest.mark.slow
def test_scatter_first_strata_sum(murky_counter_box):
    """The eval_pdf importance split (sim.py: scatter_first=-1 'direct'
    stratum + scatter_first=+1 'scattered' stratum, both weighted —
    reference chroma/sim.py:219, photon.h:205-232) partitions the path
    space: the strata's weighted detection estimates must SUM to the
    brute-force estimate."""
    n = 30000
    photons = _isotropic(n, 22)

    p_mc = run(murky_counter_box, photons, key=300, max_steps=30)
    est_mc = ((p_mc.flags & event.SURFACE_DETECT) != 0).mean()
    sig_mc = np.sqrt(est_mc * (1 - est_mc) / n)

    parts = {}
    for sf in (-1, +1):
        p_s = run(murky_counter_box, photons, key=400 + sf, max_steps=30,
                  use_weights=True, scatter_first=sf)
        det = ((p_s.flags & event.SURFACE_DETECT) != 0)
        parts[sf] = float(np.sum(p_s.weights * det) / n)
    # the direct stratum must dominate (scat_len ~ 2x box half-size)
    assert parts[-1] > parts[+1] > 0.0
    est_strat = parts[-1] + parts[+1]
    assert abs(est_strat - est_mc) < 5 * sig_mc, (parts, est_mc, sig_mc)
