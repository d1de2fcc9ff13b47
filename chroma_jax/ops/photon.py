"""Device photon batches and the propagation driver loop.

Replaces the reference host-side photon manager (reference:
chroma/gpu/photon.py GPUPhotons): upload/download photon SoA state,
run the step loop, extract hits.  Instead of double-buffered work
queues with atomic appends (gpu/photon.py:192-259), the loop
partitions terminated photons to the end of the batch between rounds
and shrinks the working prefix to the live population (an O(n)
partition; a Morton sort for gather coherence did not pay); the step
loop exits when all photons carry terminal flags.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops.propagate import propagate_step, make_photon_state

_VEC = ('pos', 'dir', 'pol')


def upload_photons(photons):
    """chroma_jax.event.Photons -> device SoA state dict."""
    return make_photon_state(
        pos=photons.pos, dir=photons.dir, pol=photons.pol,
        wavelength=photons.wavelengths, t=photons.t,
        weight=photons.weights, flags=photons.flags,
        last_hit_triangle=photons.last_hit_triangles,
        evidx=photons.evidx)


def download_photons(state):
    """Device SoA state dict -> chroma_jax.event.Photons."""
    get = lambda k: np.asarray(state[k])
    return event.Photons(
        pos=get('pos'), dir=get('dir'), pol=get('pol'),
        wavelengths=get('wavelength'), t=get('t'),
        last_hit_triangles=get('last_hit_triangle'), flags=get('flags'),
        weights=get('weight'), evidx=get('evidx'))


def _morton_key(state, world_origin, inv_extent):
    """30-bit Morton key of position (plus direction octant in the low
    bits) with terminated photons forced to the end."""
    q = jnp.clip((state['pos'] - world_origin) * inv_extent, 0.0, 1.0)
    q = (q * 1023.0).astype(jnp.uint32)

    def spread(x):
        x = (x | (x << jnp.uint32(16))) & jnp.uint32(0x030000FF)
        x = (x | (x << jnp.uint32(8))) & jnp.uint32(0x0300F00F)
        x = (x | (x << jnp.uint32(4))) & jnp.uint32(0x030C30C3)
        x = (x | (x << jnp.uint32(2))) & jnp.uint32(0x09249249)
        return x

    key = (spread(q[:, 0]) | (spread(q[:, 1]) << jnp.uint32(1))
           | (spread(q[:, 2]) << jnp.uint32(2)))
    dead = (state['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) != 0
    return jnp.where(dead, jnp.uint32(0xFFFFFFFF), key)


def sort_photons(state, world_origin, inv_extent):
    """Reorder the batch for traversal coherence; dead photons last.

    partition_photons is the production path (Morton coherence did not
    pay where it was profiled, tools/profile_step.py sections C/D);
    this full sort is kept for comparison."""
    key = _morton_key(state, world_origin, inv_extent)
    order = jnp.argsort(key)
    return {k: v[order] for k, v in state.items()}, order


def partition_photons(state):
    """Stable partition: live photons first, dead photons last.

    A cumsum + 1D-scatter permutation — O(n) with no sort, and the
    only property the compacting driver actually needs."""
    n = state['flags'].shape[0]
    alive = (state['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    cnt = jnp.cumsum(alive.astype(jnp.int32))
    dead_rank = jnp.cumsum((~alive).astype(jnp.int32)) - 1
    dest = jnp.where(alive, cnt - 1, cnt[-1] + dead_rank)
    order = jnp.zeros(n, jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32))
    return {k: v[order] for k, v in state.items()}, order


@partial(jax.jit, static_argnames=('max_steps', 'use_weights',
                                   'sort_every'))
def propagate(state, geom, key, max_steps=100, use_weights=False,
              scatter_first=0, sort_every=0):
    """Propagate all photons to termination or ``max_steps``.

    Equivalent of the reference propagate kernel loop
    (chroma/cuda/propagate.cu:217 + chroma/gpu/photon.py:192).
    ``scatter_first`` (+1 force / -1 forbid first-step scattering) only
    applies on step 0, as in the reference.
    """
    world_origin = geom.world_origin
    extent = geom.world_scale * 65535.0
    inv_extent = 1.0 / extent

    def cond(carry):
        state, step, key = carry
        alive = (state['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
        return jnp.any(alive) & (step < max_steps)

    def body(carry):
        state, step, key = carry
        key, sk = jax.random.split(key)
        if sort_every == 1:
            state, _ = sort_photons(state, world_origin, inv_extent)
        elif sort_every:
            do = (step % sort_every) == 0
            sorted_state, _ = sort_photons(state, world_origin, inv_extent)
            state = jax.tree_util.tree_map(
                lambda a, b: jnp.where(jnp.broadcast_to(do, b.shape), b, a),
                state, sorted_state)
        sf = jnp.where(step == 0, scatter_first, 0)
        state = propagate_step(state, geom, sk, sf,
                               use_weights=use_weights)
        return state, step + 1, key

    state, steps, _ = jax.lax.while_loop(
        cond, body, (state, jnp.zeros((), jnp.int32), key))
    return state, steps


def _next_pow2(n):
    return 1 << max(int(np.ceil(np.log2(max(n, 1)))), 0)


def propagate_compacting(state, geom, key, max_steps=100,
                         use_weights=False, scatter_first=0,
                         steps_per_round=1, min_bucket=8192,
                         trickle_rounds=96):
    """Host-driven wavefront propagation with live-photon compaction.

    The reference keeps its batch dense with double-buffered work
    queues compacted by atomic appends (reference:
    chroma/gpu/photon.py:192-259).  Under jit, shapes are static, so
    instead: photons are kept Morton-sorted with terminated photons at
    the back, and each round runs ``steps_per_round`` steps on only the
    smallest power-of-two prefix that covers the live photons.  Work
    shrinks with the surviving population — the classic wavefront
    scheme — at the cost of one host sync per round and one compile per
    (bucket, round-size) pair.
    """
    import os
    import time as _time
    profile = bool(os.environ.get('CHROMA_JAX_PROFILE_ROUNDS'))

    n = state['pos'].shape[0]
    world_origin = geom.world_origin
    inv_extent = 1.0 / (geom.world_scale * 65535.0)

    total_steps = 0
    first = True
    bucket = n
    t_prev = _time.time()
    while total_steps < max_steps:
        if not first:
            # partition so live photons form a prefix (dead to the end)
            state, _ = _partition_jit(state)
            alive = int(_count_alive_jit(state))
            if alive == 0:
                break
            bucket = min(_next_pow2(max(alive, 256)), n)
        sub = {k: v[:bucket] for k, v in state.items()}
        key, sk = jax.random.split(key)
        sf = scatter_first if first else 0
        if bucket <= min_bucket:
            # the surviving trickle: early-exiting chunks, re-shrunk
            # every few steps as the population dies off
            rounds = min(trickle_rounds, max_steps - total_steps)
        else:
            rounds = min(steps_per_round, max_steps - total_steps)
        sub, _ = propagate(sub, geom, sk, max_steps=rounds,
                           use_weights=use_weights, scatter_first=sf,
                           sort_every=0)
        if bucket == n:
            state = sub
        else:
            state = {k: jnp.concatenate([sub[k], v[bucket:]])
                     for k, v in state.items()}
        total_steps += rounds
        first = False
        if profile:
            jax.block_until_ready(state['flags'])
            now = _time.time()
            print('round: bucket=%7d rounds=%3d dt=%.3fs'
                  % (bucket, rounds, now - t_prev), flush=True)
            t_prev = now
    # restore the caller's photon order (the sorts permuted the batch)
    state = unsort_photons(state)
    return state, total_steps


@partial(jax.jit)
def unsort_photons(state):
    """Invert the accumulated partition permutations via the carried
    original-index field (an O(n) scatter — the index is a
    permutation, so no sort is needed)."""
    n = state['index'].shape[0]
    order = jnp.zeros(n, jnp.int32).at[state['index'].astype(jnp.int32)
                                       ].set(jnp.arange(n, dtype=jnp.int32))
    return {k: v[order] for k, v in state.items()}


@partial(jax.jit)
def _count_alive_jit(state):
    alive = (state['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    return jnp.sum(alive)


@partial(jax.jit)
def _sort_jit(state, geom):
    world_origin = geom.world_origin
    inv_extent = 1.0 / (geom.world_scale * 65535.0)
    return sort_photons(state, world_origin, inv_extent)


@partial(jax.jit)
def _partition_jit(state):
    return partition_photons(state)
