"""Histogram / parabola / color / generator / pi0 unit tests
(model: reference test_generator_vertex.py, test_parabola.py)."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax.histogram import Histogram, HistogramDD
from chroma_jax.parabola import parabola_fit, parabola_eval, minimum
from chroma_jax.color import map_wavelength, map_to_color
from chroma_jax.generator import vertex as gv
from chroma_jax.pi0 import pi0_decay, PI0_MASS
from chroma_jax.sample import uniform_sphere
from itertools import islice


def test_histogram_fill():
    h = Histogram(10, (0, 10))
    h.fill([0.5, 1.5, 1.6, 9.5])
    assert h.hist[0] == 1
    assert h.hist[1] == 2
    assert h.nentries == 4
    assert h.eval(1.55) == 2
    val, err = h.ueval(1.55)
    assert err == pytest.approx(np.sqrt(2))
    h.normalize()
    assert (h.hist * np.diff(h.bins)).sum() == pytest.approx(1.0)


def test_histogramdd():
    h = HistogramDD((5, 5), range=((0, 5), (0, 5)))
    h.fill([[0.5, 0.5], [0.5, 0.5], [4.5, 4.5]])
    assert h.hist[0, 0] == 2
    assert h.eval((4.7, 4.7)) == 1


def test_parabola_fit_exact():
    rng = np.random.RandomState(0)
    A = np.array([[2.0, 0.3], [0.3, 1.0]])
    b = np.array([1.0, -2.0])
    c = 5.0
    x = rng.uniform(-3, 3, (50, 2))
    y = c + x @ b + np.einsum('ni,ij,nj->n', x, A, x)
    c2, b2, A2, cov, chi2, prob = parabola_fit(x, y)
    assert c2 == pytest.approx(c, abs=1e-6)
    np.testing.assert_allclose(b2, b, atol=1e-6)
    np.testing.assert_allclose(A2, A, atol=1e-6)
    xmin, ymin = minimum(c2, b2, A2)
    grad = b + 2 * A @ xmin
    np.testing.assert_allclose(grad, 0.0, atol=1e-6)


def test_pi0_decay_kinematics():
    """Energy conservation + invariant mass of the photon pair."""
    (e1, d1), (e2, d2) = pi0_decay(500.0, (0, 0, 1), 0.7, 1.3)
    assert e1 + e2 == pytest.approx(500.0, rel=1e-6)
    # invariant mass m^2 = 2 e1 e2 (1 - cos theta12)
    cos12 = float(np.dot(d1, d2))
    m2 = 2 * e1 * e2 * (1 - cos12)
    assert np.sqrt(m2) == pytest.approx(PI0_MASS, rel=1e-5)


def test_particle_gun():
    gun = gv.constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 100.0)
    events = list(islice(gun, 3))
    assert len(events) == 3
    for i, ev in enumerate(events):
        assert ev.id == i
        assert ev.vertices[0].particle_name == 'e-'
        assert ev.vertices[0].ke == 100.0
        np.testing.assert_allclose(
            np.linalg.norm(ev.vertices[0].dir), 1.0)


def test_pi0_gun():
    gun = gv.constant_particle_gun('pi0', (0, 0, 0), (0, 0, 1), 200.0)
    ev = next(iter(gun))
    assert len(ev.vertices) == 2
    assert all(v.particle_name == 'gamma' for v in ev.vertices)
    assert sum(v.ke for v in ev.vertices) == \
        pytest.approx(200.0 + PI0_MASS, rel=1e-6)


def test_uniform_sphere():
    pts = uniform_sphere(5000)
    np.testing.assert_allclose(np.linalg.norm(pts, axis=1), 1.0,
                               rtol=1e-6)
    assert abs(pts.mean(axis=0)).max() < 0.05


def test_map_wavelength():
    rgb = map_wavelength([450.0, 550.0, 650.0])
    assert rgb.shape == (3, 3)
    assert rgb[0, 2] > rgb[0, 0]   # 450nm is blue
    assert rgb[1, 1] > rgb[1, 2]   # 550nm is green
    assert rgb[2, 0] > rgb[2, 2]   # 650nm is red


def test_map_to_color():
    colors = map_to_color(np.array([0.0, 0.5, 1.0]))
    assert colors.dtype == np.uint32
    assert len(np.unique(colors)) == 3


def test_parametric_generator():
    from chroma_jax.generator.photon import ParametricGenerator
    from chroma_jax.demo.optics import water
    from chroma_jax import event as evmod
    gen = ParametricGenerator(water, rng=np.random.RandomState(0))
    v = evmod.Vertex('e-', (0, 0, 0), (0, 0, 1), 100.0)
    photons = gen.generate_photons([v])
    # shower track length ~440 mm/100MeV x ~790 photons/cm
    assert len(photons) > 10000
    assert ((photons.flags & evmod.CHERENKOV) > 0).all()
    # Cherenkov ring: distribution peaks at cos(theta_c)~0.75, smeared
    # toward lower cos by the shower's electron angles
    cos = photons.dir @ np.array([0, 0, 1.0])
    hist, edges = np.histogram(cos, bins=40, range=(-1, 1))
    peak = (edges[hist.argmax()] + edges[hist.argmax() + 1]) / 2
    assert abs(peak - 1 / 1.345) < 0.06
    assert 0.6 < cos.mean() < 0.75
