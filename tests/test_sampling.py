"""CDF sampler distribution tests (model: reference
test/test_sample_cdf.py — Kolmogorov test of the device sampler against
the source distribution)."""
import numpy as np
import pytest
from scipy import stats

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from chroma_jax.ops.geometry_pack import inverse_cdf, sample_icdf


@pytest.mark.parametrize('distribution', [
    stats.norm(loc=5.0, scale=1.5),
    stats.expon(scale=3.0),
    stats.uniform(loc=2.0, scale=4.0),
])
def test_inverse_cdf_sampler_ks(distribution):
    """Samples drawn through the tabulated inverse CDF match the source
    distribution (KS p > 0.01), reference: test_sample_cdf.py:54."""
    x = np.linspace(distribution.ppf(1e-5), distribution.ppf(1 - 1e-5),
                    500)
    cdf_y = distribution.cdf(x)
    icdf = jnp.asarray(inverse_cdf(x, cdf_y))
    u = jax.random.uniform(jax.random.PRNGKey(3), (20000,))
    samples = np.asarray(sample_icdf(icdf, u))
    ks = stats.kstest(samples, distribution.cdf)
    assert ks.pvalue > 0.01, ks


def test_inverse_cdf_bimodal():
    """Sharply bimodal CDFs survive inversion."""
    x = np.linspace(0, 10, 1000)
    pdf = stats.norm(2, 0.2).pdf(x) + stats.norm(8, 0.2).pdf(x)
    cdf = np.cumsum(pdf)
    cdf /= cdf[-1]
    icdf = jnp.asarray(inverse_cdf(x, cdf))
    u = jax.random.uniform(jax.random.PRNGKey(4), (20000,))
    samples = np.asarray(sample_icdf(icdf, u))
    near_peaks = ((np.abs(samples - 2) < 1) | (np.abs(samples - 8) < 1))
    assert near_peaks.mean() > 0.98
    # both modes populated roughly equally
    assert abs((samples < 5).mean() - 0.5) < 0.05


def test_degenerate_cdf():
    """A zero CDF collapses to the left edge instead of NaN."""
    icdf = inverse_cdf(np.array([1.0, 2.0]), np.array([0.0, 0.0]))
    assert np.all(icdf == 1.0)
