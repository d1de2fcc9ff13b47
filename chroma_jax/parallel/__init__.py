"""Multi-device scaling: photon-axis data parallelism over a device mesh.

This capability is NEW relative to the reference, which is strictly
single-GPU (reference: chroma/sim.py:44 selects one CUDA device).  The
engine shards the photon axis across devices with ``shard_map`` over a
1-D mesh: the geometry tables are replicated in every device's memory,
each shard runs the full fused propagation loop independently (no
communication in the hot loop — photons are embarrassingly parallel),
and the DAQ channel accumulators are combined across shards with
collectives (min over earliest times, sum over charge, OR over channel
histories) — the collective analog of the reference's atomicMin /
atomicAdd / atomicOr (chroma/cuda/daq.cu:73-75).  The mesh follows the
algorithm only: one photon axis over every device.

Multi-host batches distribute exactly like the reference's ZMQ event
batching — host code is unchanged.
"""
from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from chroma_jax.ops import photon as photon_ops
from chroma_jax.ops.daq import run_daq
from chroma_jax.ops.fused import propagate_fused


def _propagate_local(local_state, geom, key, max_steps, use_weights,
                     scatter_first):
    """Per-shard propagation through the fused megakernel driver.

    The carried ``index`` is GLOBAL across shards; propagate_fused
    re-indexes locally for its pool scatters and passes the caller's
    index through unchanged (order is preserved by construction)."""
    out, _ = propagate_fused(local_state, geom, key, max_steps=max_steps,
                             use_weights=use_weights,
                             scatter_first=scatter_first)
    return out


def make_photon_mesh(devices=None, axis_name='photons'):
    """1D device mesh over all (or the given) devices."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def pad_to_multiple(state, multiple):
    """Pad a photon state dict so the batch divides the mesh size.
    Padding photons carry terminal flags and zero weight."""
    from chroma_jax import event
    n = state['pos'].shape[0]
    pad = -n % multiple
    if pad == 0:
        return state, n
    def pad_arr(k, v):
        filler = jnp.zeros((pad,) + v.shape[1:], v.dtype)
        if k == 'flags':
            filler = jnp.full((pad,), event.NO_HIT, jnp.uint32)
        if k == 'last_hit_triangle':
            filler = jnp.full((pad,), -1, jnp.int32)
        if k == 'evidx':
            filler = jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)
        return jnp.concatenate([v, filler])
    out = {k: pad_arr(k, v) for k, v in state.items()}
    if 'index' in out:
        out['index'] = jnp.arange(out['pos'].shape[0], dtype=jnp.uint32)
    return out, n


@lru_cache(maxsize=64)
def _sharded_propagate_fn(mesh, max_steps, use_weights):
    """Build ONCE per (mesh, statics): re-tracing the fused driver
    under shard_map on every call costs seconds of host time (the
    per-event stall that made small sharded batches pathological)."""
    axis = mesh.axis_names[0]

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis), None, None, None),
             out_specs=P(axis),
             check_vma=False)
    def _run(local_state, geom, key, scatter_first):
        local_key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        return _propagate_local(local_state, geom, local_key,
                                max_steps, use_weights, scatter_first)

    return jax.jit(_run)


def propagate_sharded(state, geom, key, mesh, max_steps=100,
                      use_weights=False, scatter_first=0):
    """Propagate a photon batch sharded across the mesh's devices
    (each shard runs the fused megakernel driver independently — no
    communication in the hot loop).

    The batch size must divide the mesh (see pad_to_multiple).
    Returns the propagated state, still sharded.
    """
    fn = _sharded_propagate_fn(mesh, max_steps, use_weights)
    return fn(state, geom, key, scatter_first)


@lru_cache(maxsize=64)
def _sharded_daq_fn(mesh, nchannels, max_steps, ndaq, nevents):
    axis = mesh.axis_names[0]

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(axis), None, None, None),
             out_specs=(P(axis), P()),
             check_vma=False)
    def _run(local_state, geom, det, key):
        local_key = jax.random.fold_in(key, jax.lax.axis_index(axis))
        k_prop, k_daq = jax.random.split(local_key)
        out = _propagate_local(local_state, geom, k_prop, max_steps,
                               False, 0)
        chan = run_daq(out, geom, det, k_daq, nchannels,
                       ndaq=ndaq, nevents=nevents)
        # collectives in place of device atomics
        t = jax.lax.pmin(chan['t'], axis)
        q = jax.lax.psum(chan['q'], axis)
        # bitwise OR across shards: gather and fold (channel arrays are
        # small compared to photon arrays)
        all_flags = jax.lax.all_gather(chan['flags'], axis)
        flags = jax.lax.reduce(all_flags, jnp.uint32(0),
                               jax.lax.bitwise_or, (0,))
        return out, dict(t=t, q=q, flags=flags)

    return jax.jit(_run)


def propagate_and_daq_sharded(state, geom, det, key, mesh, nchannels,
                              max_steps=100, ndaq=1, nevents=1):
    """One full sharded step: propagate + DAQ + cross-device channel
    reduction.  This is the framework's multi-device "step":
    channel earliest-times combine with a min-collective, charges with
    psum, and channel histories with a bitwise OR across shards.
    ``nevents`` > 1 digitizes a multi-event megabatch into per-event
    channel blocks keyed by photon evidx (see ops.daq.run_daq).

    Returns (sharded propagated state, replicated channel dict).
    """
    fn = _sharded_daq_fn(mesh, nchannels, max_steps, ndaq, nevents)
    return fn(state, geom, det, key)
