"""Event-reconstruction likelihoods (parity: chroma/likelihood.py).

Negative log likelihood of an observed event given a vertex
hypothesis: per-channel hit/no-hit Bernoulli terms plus the
probability density of the observed hit times (variable-bin or KDE
estimators from chroma_jax.ops.pdf).  Uncertainties are propagated
with a small internal value+-sigma type instead of the external
``uncertainties`` package.
"""
from itertools import islice

import numpy as np

from chroma_jax.log import logger


class UFloat(object):
    """Minimal value +/- standard-deviation container."""

    __slots__ = ('nominal_value', 'std_dev')

    def __init__(self, nominal_value, std_dev=0.0):
        self.nominal_value = float(nominal_value)
        self.std_dev = float(std_dev)

    def __add__(self, other):
        if isinstance(other, UFloat):
            return UFloat(self.nominal_value + other.nominal_value,
                          np.hypot(self.std_dev, other.std_dev))
        return UFloat(self.nominal_value + other, self.std_dev)

    __radd__ = __add__

    def __neg__(self):
        return UFloat(-self.nominal_value, self.std_dev)

    def __float__(self):
        return self.nominal_value

    def __repr__(self):
        return '%g +/- %g' % (self.nominal_value, self.std_dev)


class Likelihood(object):
    """Likelihood evaluator for detector events (reference:
    chroma/likelihood.py:7)."""

    def __init__(self, sim, event=None, tbins=100, trange=(-0.5, 999.5),
                 qbins=10, qrange=(-0.5, 49.5), time_only=True):
        self.sim = sim
        self.tbins = tbins
        self.trange = trange
        self.qbins = qbins
        self.qrange = qrange
        self.time_only = time_only
        if event is not None:
            self.set_event(event)

    def set_event(self, event):
        self.event = event

    def eval_channel_vbin(self, vertex_generator, nevals, nreps=16,
                          ndaq=50, min_bin_content=320):
        """(hit probabilities, PDF values, PDF uncertainties) per
        channel using the variable-bin window method."""
        ntotal = nevals * nreps * ndaq
        vertex_generator = islice(vertex_generator, nevals)

        hitcount, pdf_prob, pdf_prob_uncert = self.sim.eval_pdf(
            self.event.channels, vertex_generator, 0.2, self.trange,
            1, self.qrange, nreps=nreps, ndaq=ndaq,
            time_only=self.time_only, min_bin_content=min_bin_content)

        hit_prob = hitcount.astype(np.float64) / ntotal

        bad_value = (pdf_prob <= 0.0) | np.isnan(pdf_prob)
        if self.time_only:
            pdf_floor = 1.0 / (self.trange[1] - self.trange[0])
        else:
            pdf_floor = 1.0 / (self.trange[1] - self.trange[0]) \
                / (self.qrange[1] - self.qrange[0])
        pdf_prob[bad_value] = pdf_floor
        pdf_prob_uncert[bad_value] = pdf_floor
        logger.info('channels with no data: %d',
                    int((bad_value & self.event.channels.hit).sum()))
        return hit_prob, pdf_prob, pdf_prob_uncert

    def eval(self, vertex_generator, nevals, nreps=16, ndaq=50):
        """Negative log likelihood (UFloat) that the set event came
        from ``vertex_generator``."""
        ntotal = nevals * nreps * ndaq
        hit_prob, pdf_prob, pdf_prob_uncert = self.eval_channel_vbin(
            vertex_generator, nevals, nreps, ndaq)

        hit = self.event.channels.hit
        hit_prob = hit_prob.copy()
        hit_prob[~hit] = 1.0 - hit_prob[~hit]
        hit_prob = np.maximum(hit_prob, 0.5 / ntotal)

        log_likelihood = UFloat(np.log(hit_prob).sum(), 0.0)

        pdf_term = np.log(pdf_prob[hit]).sum()
        with np.errstate(divide='ignore', invalid='ignore'):
            rel = np.where(pdf_prob[hit] > 0,
                           pdf_prob_uncert[hit] / pdf_prob[hit], 0.0)
        pdf_sigma = np.sqrt((rel ** 2).sum())
        log_likelihood = log_likelihood + UFloat(pdf_term, pdf_sigma)
        return -log_likelihood

    def setup_kernel(self, vertex_generator, nevals, nreps, ndaq,
                     oversample_factor):
        bandwidth_generator = islice(vertex_generator,
                                     nevals * oversample_factor)
        self.sim.setup_kernel(self.event.channels, bandwidth_generator,
                              self.trange, self.qrange, nreps=nreps,
                              ndaq=ndaq, time_only=self.time_only,
                              scale_factor=oversample_factor)

    def eval_kernel(self, vertex_generator, nevals, nreps=16, ndaq=50,
                    navg=1):
        """Negative log likelihood via the KDE estimator."""
        ntotal = nevals * nreps * ndaq
        nll = []
        for _ in range(navg):
            kernel_generator = islice(vertex_generator, nevals)
            hitcount, pdf_prob, _ = self.sim.eval_kernel(
                self.event.channels, kernel_generator, self.trange,
                self.qrange, nreps=nreps, ndaq=ndaq,
                time_only=self.time_only)
            hit = self.event.channels.hit
            hit_prob = hitcount.astype(np.float64) / ntotal
            hit_prob[~hit] = 1.0 - hit_prob[~hit]
            hit_prob = np.maximum(hit_prob, 0.5 / ntotal)
            pdf = np.maximum(pdf_prob[hit],
                             0.01 / (self.trange[1] - self.trange[0]))
            nll.append(-(np.log(hit_prob).sum() + np.log(pdf).sum()))
        nll = np.asarray(nll)
        return UFloat(nll.mean(), nll.std() / max(np.sqrt(len(nll)), 1))
