"""DAQ: digitize detected photons into per-channel (time, charge).

Replaces the reference's atomic DAQ kernels (reference:
chroma/cuda/daq.cu run_daq / run_daq_many) with segment reductions:
earliest hit time via scatter-min over channel ids (instead of
atomicMin on float-as-sortable-int), integrated charge via quantized
scatter-add (same charge_unit quantization as the reference), and the
channel history word via per-bit scatter-max (in place of atomicOr).

Transit-time and single-PE charge smearing sample the detector's
shared CDFs through inverse-CDF tables (one gather + lerp each).
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops.geometry_pack import sample_icdf

# bits that can appear in a photon history word
_HISTORY_BITS = tuple(range(12)) + (31,)


@partial(jax.jit, static_argnames=('nchannels', 'ndaq', 'nevents'))
def run_daq(state, geom, det, key, nchannels, ndaq=1, nevents=1,
            global_weight=1.0, detection_state=event.SURFACE_DETECT):
    """One DAQ acquisition over a propagated photon batch.

    Returns dict(t, q, flags), each (nevents*ndaq*C,), with unhit
    channels at t = 1e9 — the same "earliest time" convention as the
    reference (chroma/gpu/daq.py begin_acquire).  With ``nevents`` > 1
    photons accumulate into per-event channel blocks keyed by their
    ``evidx`` (one fused segment reduction digitizes a whole
    multi-event megabatch — the reference loops events instead,
    chroma/sim.py:134); photons with evidx outside [0, nevents) are
    dropped (batch padding carries evidx = 0xFFFFFFFF).
    """
    n = state['pos'].shape[0]
    tri = state['last_hit_triangle']
    flags = state['flags']

    solid = geom.solid_id_map[jnp.maximum(tri, 0)]
    channel = det.solid_id_to_channel_index[solid]
    evidx = state['evidx'].astype(jnp.int32)
    detected = (tri >= 0) & ((flags & jnp.uint32(detection_state)) != 0) \
        & (channel >= 0) & (evidx >= 0) & (evidx < nevents)

    u = jax.random.uniform(key, (3, ndaq, n), dtype=jnp.float32)
    weight = state['weight'] * global_weight
    keep = detected[None, :] & (u[0] < weight[None, :])

    t_smear = sample_icdf(det.time_icdf, u[1].reshape(-1)).reshape(ndaq, n)
    times = state['t'][None, :] + t_smear
    charge = sample_icdf(det.charge_icdf, u[2].reshape(-1)).reshape(ndaq, n)
    q_int = jnp.round(charge / det.charge_unit).astype(jnp.uint32)

    # channel slot per (event block, daq copy); dropped when not kept
    total = nchannels * ndaq * nevents
    slot = channel[None, :] + nchannels * (
        jnp.arange(ndaq)[:, None] + ndaq * evidx[None, :])
    slot = jnp.where(keep, slot, total).reshape(-1)  # out of range -> drop

    times = jnp.where(keep, times, 1e9).reshape(-1)
    q_int = jnp.where(keep, q_int, 0).reshape(-1)

    earliest = jnp.full(total, 1e9, jnp.float32) \
        .at[slot].min(times, mode='drop')
    q_sum = jnp.zeros(total, jnp.uint32).at[slot].add(q_int, mode='drop')

    hist = jnp.zeros(total, jnp.uint32)
    ph_flags = jnp.broadcast_to(flags[None, :], (ndaq, n)).reshape(-1)
    for b in _HISTORY_BITS:
        bit = (ph_flags >> jnp.uint32(b)) & jnp.uint32(1)
        got = jnp.zeros(total, jnp.uint32).at[slot].max(bit, mode='drop')
        hist = hist | (got << jnp.uint32(b))

    return dict(t=earliest, q=q_sum.astype(jnp.float32) * det.charge_unit,
                flags=hist)


class GPUChannels(object):
    """Channel readout buffers (parity: chroma/gpu/daq.py GPUChannels)."""

    def __init__(self, t, q, flags, ndaq=1, stride=None):
        self.t = t
        self.q = q
        self.flags = flags
        self.ndaq = ndaq
        self.stride = stride if stride is not None else len(t) // ndaq

    def iterate_copies(self):
        for i in range(self.ndaq):
            sl = slice(i * self.stride, (i + 1) * self.stride)
            yield GPUChannels(self.t[sl], self.q[sl], self.flags[sl])

    def get(self):
        """Download as an event.Channels; channels with t<1e8 are hit."""
        t = np.asarray(self.t)
        q = np.asarray(self.q)
        return event.Channels(t < 1e8, t, q, np.asarray(self.flags))

    def __len__(self):
        return self.t.size


class GPUDaq(object):
    """DAQ driver (parity: chroma/gpu/daq.py GPUDaq)."""

    def __init__(self, gpu_detector, ndaq=1):
        self.geom = gpu_detector.geom
        self.det = gpu_detector.det
        self.nchannels = gpu_detector.det.nchannels
        self.ndaq = ndaq
        self.stride = self.nchannels
        self._acc = None

    def begin_acquire(self, *args, **kwargs):
        self._acc = None

    def acquire(self, photons, rng_states, weight=1.0, **ignored):
        state = photons.state if hasattr(photons, 'state') else photons
        key = rng_states.next() if hasattr(rng_states, 'next') \
            else rng_states
        res = run_daq(state, self.geom, self.det, key, self.nchannels,
                      ndaq=self.ndaq, global_weight=weight)
        if self._acc is None:
            self._acc = res
        else:
            self._acc = dict(
                t=jnp.minimum(self._acc['t'], res['t']),
                q=self._acc['q'] + res['q'],
                flags=self._acc['flags'] | res['flags'])
        return self._acc

    def end_acquire(self, *args, **kwargs):
        res = self._acc
        if res is None:
            res = dict(t=jnp.full(self.nchannels * self.ndaq, 1e9),
                       q=jnp.zeros(self.nchannels * self.ndaq),
                       flags=jnp.zeros(self.nchannels * self.ndaq,
                                       jnp.uint32))
        return GPUChannels(res['t'], res['q'], res['flags'], self.ndaq,
                           self.stride)
