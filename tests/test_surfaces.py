"""Statistical validation of the WLS and dichroic surface models.

The reference implements these in chroma/cuda/photon.h:592
(propagate_at_wls) and photon.h:640 (propagate_at_dichroic); the
reference test suite never exercised them, so these tests are built
from the *specified* behavior:

  WLS      absorb with P=absorb(wl); absorbed photons reemit with
           P=reemit(wl) at a wavelength drawn from reemission_cdf,
           isotropically; non-absorbed photons reflect with
           P=reflect_specular+reflect_diffuse (split in that ratio)
           or pass through (SURFACE_TRANSMIT -> Fresnel).
  DICHROIC reflect/transmit with probabilities bilinearly interpolated
           from an (incidence angle x wavelength) table; the remainder
           is absorbed.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax

from chroma_jax import event, make
from chroma_jax.geometry import (Solid, Geometry, Surface, Material,
                                 DichroicProps, vacuum,
                                 SURFACE_WLS, SURFACE_DICHROIC)
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.ops.geometry_pack import pack_geometry
from chroma_jax.ops import photon as gpu_photon


def run(geom, photons, key=0, max_steps=10, **kw):
    state = gpu_photon.upload_photons(photons)
    out, steps = gpu_photon.propagate(state, geom,
                                      jax.random.PRNGKey(key),
                                      max_steps=max_steps, **kw)
    out = gpu_photon.unsort_photons(out)
    return gpu_photon.download_photons(out)


def oblique_photons(n, theta=0.0, wavelength=400.0):
    """Photons from the origin hitting the +z wall of a centered box
    at incidence angle ``theta`` (radians from the wall normal)."""
    pos = np.zeros((n, 3), dtype=np.float32)
    dir = np.tile([np.sin(theta), 0.0, np.cos(theta)],
                  (n, 1)).astype(np.float32)
    phi = np.random.RandomState(5).uniform(0, 2 * np.pi, n)
    # polarization perpendicular to dir
    a = np.stack([np.cos(theta) * np.cos(phi), np.sin(phi),
                  -np.sin(theta) * np.cos(phi)], axis=1)
    return event.Photons(pos=pos, dir=dir, pol=a.astype(np.float32),
                         wavelengths=np.full(n, wavelength, np.float32))


def boxed(surface):
    world = Geometry(vacuum)
    world.add_solid(Solid(make.box(100, 100, 100), vacuum, vacuum,
                          surface=surface))
    geo = create_geometry_from_obj(world, update_bvh_cache=False)
    return pack_geometry(geo)


# ---------------------------------------------------------------------
# WLS (photon.h:592)
# ---------------------------------------------------------------------

WLS_ABSORB = 0.6
WLS_REEMIT = 0.5
WLS_RSPEC = 0.12
WLS_RDIFF = 0.08


@pytest.fixture(scope='module')
def wls_box():
    from scipy import stats as sstats
    surf = Surface('wls', model=SURFACE_WLS)
    surf.set('absorb', WLS_ABSORB)
    surf.set('reemit', WLS_REEMIT)
    surf.set('reflect_specular', WLS_RSPEC)
    surf.set('reflect_diffuse', WLS_RDIFF)
    x = np.arange(60, 1000, 5.0)
    surf.set('reemission_cdf', sstats.norm(scale=50, loc=600).cdf(x),
             wavelengths=x)
    return boxed(surf)


@pytest.mark.slow
def test_wls_outcome_fractions(wls_box):
    """One-step outcome fractions on a WLS plane at normal incidence:
    absorb -> reemit split by reemit(wl), reflect split spec/diffuse in
    the rspec:rdiff ratio, remainder transmits."""
    n = 40000
    p = run(wls_box, oblique_photons(n, wavelength=400.0), key=21,
            max_steps=1)
    frac = lambda bit: ((p.flags & bit) > 0).mean()
    sig = lambda q: 4 * np.sqrt(q * (1 - q) / n) + 0.005
    # absorbed and not reemitted
    q = WLS_ABSORB * (1 - WLS_REEMIT)
    assert abs(frac(event.SURFACE_ABSORB) - q) < sig(q)
    # absorbed and reemitted
    q = WLS_ABSORB * WLS_REEMIT
    assert abs(frac(event.SURFACE_REEMIT) - q) < sig(q)
    # reflected (specular : diffuse in the rs : rd ratio)
    assert abs(frac(event.REFLECT_SPECULAR) - WLS_RSPEC) < sig(WLS_RSPEC)
    assert abs(frac(event.REFLECT_DIFFUSE) - WLS_RDIFF) < sig(WLS_RDIFF)
    # transmitted (vacuum/vacuum Fresnel: passes undeflected)
    q = 1.0 - WLS_ABSORB - WLS_RSPEC - WLS_RDIFF
    assert abs(frac(event.SURFACE_TRANSMIT) - q) < sig(q)
    tx = (p.flags & event.SURFACE_TRANSMIT) > 0
    np.testing.assert_allclose(p.dir[tx] - np.array([0.0, 0.0, 1.0]),
                               0.0, atol=1e-5)


def test_wls_reemission_spectrum(wls_box):
    """Reemitted photons draw their new wavelength from the surface
    reemission CDF (chi-square + KS against the generating normal)."""
    from scipy import stats as sstats
    n = 40000
    p = run(wls_box, oblique_photons(n, wavelength=400.0), key=23,
            max_steps=1)
    re = (p.flags & event.SURFACE_REEMIT) > 0
    assert re.sum() > 5000
    wl = p.wavelengths[re]
    ks = sstats.kstest(wl, sstats.norm(scale=50, loc=600).cdf)
    assert ks.pvalue > 1e-3, ks
    # reemission is isotropic: <cos(theta_z)> ~ 0
    assert abs(p.dir[re][:, 2].mean()) < 4.0 / np.sqrt(re.sum())


# ---------------------------------------------------------------------
# Dichroic (photon.h:640)
# ---------------------------------------------------------------------

# angle grid (radians) and per-angle wavelength tables on [300, 700] nm
DICH_ANGLES = np.array([0.0, np.pi / 3, np.pi / 2])
DICH_WL = np.array([250.0, 450.0, 800.0])
# reflect probability rows: angle x wavelength control points
DICH_R = np.array([[0.10, 0.50, 0.10],
                   [0.30, 0.70, 0.30],
                   [0.90, 0.90, 0.90]])
DICH_T = np.array([[0.80, 0.40, 0.80],
                   [0.55, 0.20, 0.55],
                   [0.05, 0.05, 0.05]])


@pytest.fixture(scope='module')
def dichroic_box():
    surf = Surface('dichroic', model=SURFACE_DICHROIC)
    surf.dichroic_props = DichroicProps(
        DICH_ANGLES,
        [np.column_stack([DICH_WL, DICH_R[a]]) for a in range(3)],
        [np.column_stack([DICH_WL, DICH_T[a]]) for a in range(3)])
    return boxed(surf)


def dich_expect(theta, wl):
    """Bilinear interpolation of the tables above, as specified by
    photon.h:640 (linear in angle between rows, linear in wavelength
    within a row)."""
    ai = np.searchsorted(DICH_ANGLES, theta, side='right') - 1
    ai = min(max(ai, 0), len(DICH_ANGLES) - 2)
    af = (theta - DICH_ANGLES[ai]) / (DICH_ANGLES[ai + 1] - DICH_ANGLES[ai])
    r = [np.interp(wl, DICH_WL, DICH_R[a]) for a in (ai, ai + 1)]
    t = [np.interp(wl, DICH_WL, DICH_T[a]) for a in (ai, ai + 1)]
    return (r[0] + (r[1] - r[0]) * af, t[0] + (t[1] - t[0]) * af)


@pytest.mark.parametrize('theta,wl', [
    (0.0, 450.0),            # on-grid angle, on-grid wavelength
    (0.0, 575.0),            # wavelength interpolation
    (np.pi / 6, 450.0),      # angle interpolation (between rows 0, 1)
    (0.6, 350.0),            # both interpolated
])
def test_dichroic_fractions(dichroic_box, theta, wl):
    """Reflect/transmit/absorb fractions match the bilinearly
    interpolated (angle, wavelength) table within Poisson errors."""
    n = 30000
    p = run(dichroic_box, oblique_photons(n, theta=theta, wavelength=wl),
            key=int(theta * 100) + int(wl), max_steps=1)
    r_exp, t_exp = dich_expect(theta, wl)
    refl = ((p.flags & event.REFLECT_SPECULAR) > 0).mean()
    tran = ((p.flags & event.SURFACE_TRANSMIT) > 0).mean()
    absb = ((p.flags & event.SURFACE_ABSORB) > 0).mean()
    sig = lambda q: 4 * np.sqrt(max(q * (1 - q), 1e-4) / n) + 0.003
    assert abs(refl - r_exp) < sig(r_exp), (refl, r_exp)
    assert abs(tran - t_exp) < sig(t_exp), (tran, t_exp)
    a_exp = 1.0 - r_exp - t_exp
    assert abs(absb - a_exp) < sig(a_exp), (absb, a_exp)
    # reflection is specular: mirror about the +z wall normal
    rx = (p.flags & event.REFLECT_SPECULAR) > 0
    if rx.sum() > 100:
        want = np.array([np.sin(theta), 0.0, -np.cos(theta)])
        np.testing.assert_allclose(p.dir[rx] - want[None, :], 0.0,
                                   atol=1e-5)
