"""Fused propagation: traversal iterations + physics in ONE device loop.

Every walker iteration costs the full lane width, and a host round trip
per propagation round stalls the device.  The compacting driver
(ops/photon.py propagate_compacting) already shrinks the working width
as photons die, but it still pays

  * one host sync + repartition per round,
  * a full traversal-cascade tail per step (lanes that found their hit
    idle while stragglers walk), and
  * per-iteration fixed costs on narrow trickle stages.

This module removes all three by running a *megakernel* analog: every
lane owns one in-flight photon; each loop iteration advances every
lane's BVH walk by one row; every ``SERVICE_EVERY`` iterations a
predicated physics pass (ops/propagate.physics_update) advances the
lanes whose traversal completed, retires terminated photons to the
result pool, and refills their lanes with waiting photons.  No lane
ever idles while work remains — the lock-step tail only appears when
the pool runs dry, and a two-stage lane-compaction cascade (same trick
as ops/mbvh.py) shrinks the width for that drain.

The reference equivalent is the persistent-thread propagate kernel +
double-buffered queues (chroma/cuda/propagate.cu:217,
chroma/gpu/photon.py:192), here expressed as whole-array XLA programs.

Software pipelining: the row gather and the arithmetic of one walker
iteration form a strict dependence chain (pop -> gather -> test ->
push -> pop), so the driver runs ``CHAINS`` independent lane batches
inside the same device loop, letting the scheduler overlap chain A's
row fetch with chain B's triangle tests.  Each chain owns a private
segment of the photon pool, so the chains share nothing but the jit.

RNG note: draws are consumed per *service pass*, not per photon step,
so sequences differ from ops/photon.propagate — all physics tests are
statistical, and both drivers sample the same distributions.
"""
import os
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops import mbvh
from chroma_jax.ops.mbvh import NMASK_WORDS
from chroma_jax.ops.propagate import physics_update, NDRAWS


# Walker iterations between physics passes (the CPU test suite pins a
# smaller value, conftest).  This and the width and chain constants
# below were tuned on the platform the engine was first built for, and
# are not yet measured on the H100.
SERVICE_EVERY = int(os.environ.get('CHROMA_JAX_SERVICE_EVERY', 17))
# total lane width across chains
DEFAULT_WIDTH = int(os.environ.get('CHROMA_JAX_WIDTH', 12288))
DEFAULT_CHAINS = int(os.environ.get('CHROMA_JAX_CHAINS', 3))
MIN_CHAIN_WIDTH = 2048  # below this, fall back to one chain
DRAIN_SHRINK = (8, 64)  # lane-compaction cascade for the pool-dry tail

_PHOTON_KEYS = ('pos', 'dir', 'pol', 'wavelength', 't', 'weight',
                'flags', 'last_hit_triangle', 'evidx', 'index')


def _pack(state):
    """Photon SoA -> (n, 16) u32 rows (float fields bitcast), so pool
    writeback + refill are ONE scatter + ONE gather instead of ten of
    each.  Word layout: pos[3] dir[3] pol[3] wavelength t weight
    flags lht evidx index.

    The rows are UNSIGNED INT, not float: flag words bitcast into f32
    are denormals/NaNs, and XLA is free to flush (to zero) or
    canonicalize those inside fusions it builds around a float-typed
    value.  Integer words are bit-exact under every select / gather /
    scatter, so the floats ride as bit patterns instead (the referee's
    terminal-passthrough check guards this)."""
    u32 = lambda v: jax.lax.bitcast_convert_type(v, jnp.uint32)
    return jnp.concatenate([
        u32(state['pos']), u32(state['dir']), u32(state['pol']),
        u32(state['wavelength'])[:, None], u32(state['t'])[:, None],
        u32(state['weight'])[:, None], state['flags'][:, None],
        u32(state['last_hit_triangle'])[:, None],
        state['evidx'].astype(jnp.uint32)[:, None],
        state['index'].astype(jnp.uint32)[:, None]], axis=1)


def _unpack(arr):
    f32 = lambda v: jax.lax.bitcast_convert_type(v, jnp.float32)
    i32 = lambda v: jax.lax.bitcast_convert_type(v, jnp.int32)
    return dict(pos=f32(arr[:, 0:3]), dir=f32(arr[:, 3:6]),
                pol=f32(arr[:, 6:9]), wavelength=f32(arr[:, 9]),
                t=f32(arr[:, 10]), weight=f32(arr[:, 11]),
                flags=arr[:, 12], last_hit_triangle=i32(arr[:, 13]),
                evidx=arr[:, 14], index=arr[:, 15])


def _reseed(lane, need, geom):
    """Restart the BVH walk for lanes in ``need`` (root children
    slab-tested inline — mbvh.root_seed — so the walk starts at level
    1); refresh the ray-derived walker fields from the photon state."""
    depth = lane['masks'].shape[1]
    inv_dir = 1.0 / lane['dir']
    noid = -lane['pos'] * inv_dir
    smasks, sbases, stcodes = mbvh.root_seed(geom, depth, inv_dir, noid,
                                             need)
    masks = jnp.where(need[:, None, None], smasks, lane['masks'])
    out = dict(lane)
    out.update(
        org=jnp.where(need[:, None], lane['pos'], lane['org']),
        masks=masks,
        bases=jnp.where(need[:, None], sbases, lane['bases']),
        tcodes=jnp.where(need[:, None, None], stcodes, lane['tcodes']),
        best_tri=jnp.where(need, -1, lane['best_tri']),
        min_dist=jnp.where(need, jnp.inf, lane['min_dist']),
        best_norm=jnp.where(need[:, None], 0.0, lane['best_norm']),
        best_mat=jnp.where(need, jnp.uint32(0), lane['best_mat']),
        inv_dir=jnp.where(need[:, None], inv_dir, lane['inv_dir']),
        noid=jnp.where(need[:, None], noid, lane['noid']),
        lht=jnp.where(need, lane['last_hit_triangle'], lane['lht']),
    )
    return out


def _service(lane, pool, next_ptr, key, geom, max_steps, scatter_first,
             use_weights, idx_base=0):
    """Physics + retire + refill pass over all lanes (predicated).
    ``pool`` is the packed (n, 16) photon pool (see _pack) — for a
    pipelined chain, its private pool segment, with ``idx_base`` the
    segment's first global photon index (retiring lanes scatter to
    slot ``index - idx_base``)."""
    w = lane['pos'].shape[0]
    n_pool = pool.shape[0]
    key, sk = jax.random.split(key)
    u = jax.random.uniform(sk, (w, NDRAWS), dtype=jnp.float32)

    holding = lane['holding']
    alive = (lane['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    trav_done = ~jnp.any(lane['masks'] != 0, axis=(1, 2))

    # NaN guard (reference: chroma/cuda/propagate.cu:262).  NaN lanes
    # were never reseeded, so they are trav_done with an empty result.
    bad = jnp.isnan(jnp.sum(lane['dir'], axis=1)
                    + jnp.sum(lane['pos'], axis=1))
    ready = holding & alive & trav_done & (lane['step'] < max_steps)
    nan_mask = ready & bad
    flags = jnp.where(nan_mask,
                      lane['flags']
                      | jnp.uint32(event.NO_HIT | event.NAN_ABORT),
                      lane['flags'])
    active = ready & ~bad

    res = dict(triangle=lane['best_tri'], distance=lane['min_dist'],
               normal=lane['best_norm'], material_code=lane['best_mat'],
               incomplete=jnp.zeros(w, bool))
    sf = jnp.where(lane['step'] == 0, scatter_first, 0)
    pstate = {k: lane[k] for k in _PHOTON_KEYS}
    new_state = physics_update(pstate, res, geom, u, flags, active,
                               nan_mask, sf, use_weights=use_weights)
    lane = dict(lane, **new_state)
    lane['step'] = lane['step'] + ready.astype(jnp.int32)

    # ---- retire: write finished (or out-of-steps) photons back ------
    alive2 = (lane['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    finished = holding & trav_done & (~alive2
                                      | (lane['step'] >= max_steps))
    out_idx = jnp.where(finished,
                        lane['index'].astype(jnp.int32) - idx_base, n_pool)
    packed = _pack(lane)
    pool = pool.at[out_idx].set(packed, mode='drop')

    # ---- refill from the pool ----------------------------------------
    rank = jnp.cumsum(finished.astype(jnp.int32)) - 1
    grab = next_ptr + rank
    have = finished & (grab < n_pool)
    src = jnp.clip(grab, 0, n_pool - 1)
    fresh = _unpack(jnp.where(have[:, None], pool[src], packed))
    for k in _PHOTON_KEYS:
        lane[k] = fresh[k]
    lane['step'] = jnp.where(have, 0, lane['step'])
    lane['holding'] = (holding & ~finished) | have
    next_ptr = next_ptr + jnp.sum(finished.astype(jnp.int32))

    # ---- reseed traversal for lanes starting their next step ---------
    alive3 = (lane['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    ok = ~jnp.isnan(jnp.sum(lane['dir'], axis=1)
                    + jnp.sum(lane['pos'], axis=1))
    need = lane['holding'] & alive3 & ok & trav_done \
        & (lane['step'] < max_steps)
    lane = _reseed(lane, need, geom)
    return lane, pool, next_ptr, key


def _service_all(lanes, pools, next_ptrs, keys, geom, max_steps,
                 scatter_first, use_weights, idx_bases):
    """Service every chain in ONE merged physics pass.

    Running the draw + predication lattice + physics once over the
    concatenated lanes pays the pass's per-op fixed costs once instead
    of once per chain.  Only the photon-side keys are concatenated
    (cheap (w, 3)-ish arrays); the pool retire/refill and the traversal
    reseed — which touch per-chain pools and the walker state — stay
    per chain."""
    C = len(lanes)
    if C == 1:
        lane, pool, ptr, key = _service(
            lanes[0], pools[0], next_ptrs[0], keys[0], geom, max_steps,
            scatter_first, use_weights, idx_base=idx_bases[0])
        return [lane], [pool], [ptr], [key]
    ws = [lane['pos'].shape[0] for lane in lanes]
    w_all = sum(ws)
    key0, sk = jax.random.split(keys[0])
    keys = [key0] + list(keys[1:])
    u = jax.random.uniform(sk, (w_all, NDRAWS), dtype=jnp.float32)

    def cat(k):
        return jnp.concatenate([ln[k] for ln in lanes], axis=0)

    big = {k: cat(k) for k in _PHOTON_KEYS}
    step = cat('step')
    holding = cat('holding')
    trav_done = jnp.concatenate(
        [~jnp.any(ln['masks'] != 0, axis=(1, 2)) for ln in lanes])
    parts = [dict(triangle=ln['best_tri'], distance=ln['min_dist'],
                  normal=ln['best_norm'], material_code=ln['best_mat'],
                  incomplete=jnp.zeros(w, bool))
             for w, ln in zip(ws, lanes)]
    res = {k: jnp.concatenate([p[k] for p in parts], axis=0)
           for k in parts[0]}

    alive = (big['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    bad = jnp.isnan(jnp.sum(big['dir'], axis=1)
                    + jnp.sum(big['pos'], axis=1))
    ready = holding & alive & trav_done & (step < max_steps)
    nan_mask = ready & bad
    flags = jnp.where(nan_mask,
                      big['flags']
                      | jnp.uint32(event.NO_HIT | event.NAN_ABORT),
                      big['flags'])
    active = ready & ~bad
    sf = jnp.where(step == 0, scatter_first, 0)
    new_state = physics_update(big, res, geom, u, flags, active,
                               nan_mask, sf, use_weights=use_weights)
    big.update(new_state)
    step = step + ready.astype(jnp.int32)

    # ---- split back; per-chain retire/refill/reseed tails -----------
    out_lanes, out_pools, out_ptrs = [], [], []
    off = 0
    for c in range(C):
        w = ws[c]

        def sl(v, off=off, w=w):
            return jax.lax.slice_in_dim(v, off, off + w)

        lane = dict(lanes[c], step=sl(step))
        for k in _PHOTON_KEYS:
            lane[k] = sl(big[k])
        pool, next_ptr = pools[c], next_ptrs[c]
        n_pool = pool.shape[0]
        holding_c = sl(holding)
        trav_done_c = sl(trav_done)

        alive2 = (lane['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
        finished = holding_c & trav_done_c \
            & (~alive2 | (lane['step'] >= max_steps))
        out_idx = jnp.where(
            finished, lane['index'].astype(jnp.int32) - idx_bases[c],
            n_pool)
        packed = _pack(lane)
        pool = pool.at[out_idx].set(packed, mode='drop')

        rank = jnp.cumsum(finished.astype(jnp.int32)) - 1
        grab = next_ptr + rank
        have = finished & (grab < n_pool)
        src = jnp.clip(grab, 0, n_pool - 1)
        fresh = _unpack(jnp.where(have[:, None], pool[src], packed))
        for k in _PHOTON_KEYS:
            lane[k] = fresh[k]
        lane['step'] = jnp.where(have, 0, lane['step'])
        lane['holding'] = (holding_c & ~finished) | have
        next_ptr = next_ptr + jnp.sum(finished.astype(jnp.int32))

        alive3 = (lane['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
        ok = ~jnp.isnan(jnp.sum(lane['dir'], axis=1)
                        + jnp.sum(lane['pos'], axis=1))
        need = lane['holding'] & alive3 & ok & trav_done_c \
            & (lane['step'] < max_steps)
        lane = _reseed(lane, need, geom)
        out_lanes.append(lane)
        out_pools.append(pool)
        out_ptrs.append(next_ptr)
        off += w
    return out_lanes, out_pools, out_ptrs, keys


def _compact_lanes(lane, m):
    """Stable-partition holding lanes to the front; keep the first m."""
    n = lane['holding'].shape[0]
    holding = lane['holding']
    cnt = jnp.cumsum(holding.astype(jnp.int32))
    rank_dead = jnp.cumsum((~holding).astype(jnp.int32)) - 1
    dest = jnp.where(holding, cnt - 1, cnt[-1] + rank_dead)
    src = jnp.zeros(n, jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32))
    idx = src[:m]
    return {k: (v if v.ndim == 0 else v[idx]) for k, v in lane.items()}


def _make_lane(state, geom, lo, w, depth):
    """Initial lane state for one chain: pool photons [lo, lo+w)."""
    lane = {k: jax.lax.slice_in_dim(v, lo, lo + w) for k, v in
            state.items()}
    lane_common = dict(
        holding=jnp.ones(w, bool),
        step=jnp.zeros(w, jnp.int32),
        iters=jnp.zeros((), jnp.int32),
        nactive=jnp.zeros((), jnp.int32),
    )
    alive = (lane['flags'] & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    ok = ~jnp.isnan(jnp.sum(lane['dir'], axis=1)
                    + jnp.sum(lane['pos'], axis=1))
    lane.update(lane_common)
    lane.update(
        masks=jnp.zeros((w, depth, NMASK_WORDS), jnp.uint32),
        bases=jnp.zeros((w, depth), jnp.uint32),
        tcodes=jnp.full((w, depth, mbvh.BRANCH), 65535, jnp.uint16),
        best_tri=jnp.full(w, -1, jnp.int32),
        min_dist=jnp.full(w, jnp.inf, jnp.float32),
        best_norm=jnp.zeros((w, 3), jnp.float32),
        best_mat=jnp.zeros(w, jnp.uint32),
        inv_dir=jnp.zeros((w, 3), jnp.float32),
        noid=jnp.zeros((w, 3), jnp.float32),
        lht=lane['last_hit_triangle'],
        org=lane['pos'],
        **mbvh.extra_state(geom, w),
    )
    return _reseed(lane, alive & ok, geom)


@partial(jax.jit, static_argnames=('max_steps', 'use_weights', 'width',
                                   'service_every', 'chains', 'prune',
                                   'service_frac'))
def _propagate_fused_packed(state, geom, key, max_steps=100,
                            use_weights=False, scatter_first=0,
                            width=None, service_every=SERVICE_EVERY,
                            chains=None, prune=None, service_frac=None):
    """Propagate all photons in ``state`` to termination, fused.

    Returns ``(final_state, stats)`` where ``stats`` is an int32[4]
    vector [service_passes, photon_steps, lane_iterations,
    active_lane_iterations]; stats[3] / stats[2] is the walker's lane
    utilization.  Output order == input order: retiring
    lanes scatter into the pool at slot ``index``, and the pool is
    consumed sequentially, so the state is re-indexed 0..n-1 here and
    the caller's ``index`` restored on return (an arbitrary permuted
    index input would otherwise overwrite not-yet-run photons).

    ``chains``: number of independent software-pipelined lane batches
    (see module docstring); each owns ``width/chains`` lanes and a
    private photon-pool segment.  Defaults to CHROMA_JAX_CHAINS (3),
    dropping to 1 when the batch is too small to split.

    ``service_frac``: if set (or via CHROMA_JAX_SERVICE_FRAC), use a
    *dynamic* service cadence: each chain runs its physics pass under
    ``lax.cond`` as soon as >= frac of its holding lanes (or all of
    them) have drained their walks, instead of every ``service_every``
    iterations.  RNG pairing differs from the static cadence (draws
    are consumed per service pass), so results differ seed-to-seed but
    sample the same distributions.
    """
    caller_index = state['index']
    state = dict(state, index=jnp.arange(state['pos'].shape[0],
                                         dtype=jnp.uint32))
    n = state['pos'].shape[0]
    w_total = width or min(n, DEFAULT_WIDTH)
    w_total = min(w_total, n)
    nchains = chains or DEFAULT_CHAINS
    while nchains > 1 and (w_total // nchains < MIN_CHAIN_WIDTH
                           or n // nchains < MIN_CHAIN_WIDTH):
        nchains -= 1
    depth = min(geom.mbvh_depth, mbvh.MAX_LEVELS)

    packed = _pack(state)
    # chain c owns pool segment [seg_lo[c], seg_lo[c+1]) and starts
    # holding its first w_c photons
    base, rem = divmod(n, nchains)
    seg_sizes = [base + (1 if c < rem else 0) for c in range(nchains)]
    seg_lo = np.concatenate([[0], np.cumsum(seg_sizes)]).astype(int)
    w_c = [min(w_total // nchains, seg_sizes[c]) for c in range(nchains)]

    pools = [jax.lax.slice_in_dim(packed, seg_lo[c], seg_lo[c + 1])
             for c in range(nchains)]
    lanes = [_make_lane(state, geom, seg_lo[c], w_c[c], depth)
             for c in range(nchains)]
    next_ptrs = [jnp.asarray(w_c[c], jnp.int32)
                 for c in range(nchains)]
    keys = list(jax.random.split(key, nchains))

    # stats: [services, photon_steps, lane_iters, pending_lane_iters]
    stats = jnp.zeros(4, jnp.int32)

    # lazy-prune cadence: 'half' prunes on alternate iterations
    # (default), 'off' never (cheapest body; relies on nearest-first
    # popping + the SAH tree), 'on' every iteration.
    if prune is None:
        prune = os.environ.get('CHROMA_JAX_PRUNE', 'half')
    # dynamic service cadence: service a chain whenever >= this
    # fraction of its lanes have drained (None = static service_every)
    sfrac = service_frac
    if sfrac is None:
        env_sf = os.environ.get('CHROMA_JAX_SERVICE_FRAC')
        sfrac = float(env_sf) if env_sf else None
    body_walk = mbvh._walk_body(geom, depth, do_prune=(prune != 'off'))
    body_walk_np = mbvh._walk_body(geom, depth,
                                   do_prune=(prune == 'on'))

    def _chain_pending(lane):
        return jnp.any(lane['masks'] != 0, axis=(1, 2))

    def walk_chains(lanes, wf):
        # one walker iteration of every chain, interleaved so the
        # scheduler can overlap chain A's row fetch with chain B's
        # triangle tests (the chains share no state)
        return tuple(wf(lane) for lane in lanes)

    def walk_pair(_, lanes):
        return walk_chains(walk_chains(lanes, body_walk), body_walk_np)

    def make_body():
        def body(carry):
            lanes, pools, next_ptrs, keys, stats = carry
            # service_every walker iterations, pruning on even ones.  A
            # loop over iteration pairs, not an unrolled window: XLA:GPU
            # took over ten minutes to compile the unrolled body at
            # the full demo's shapes.
            lanes = jax.lax.fori_loop(0, service_every // 2, walk_pair,
                                      tuple(lanes))
            if service_every % 2:
                lanes = walk_chains(lanes, body_walk)
            lanes = list(lanes)
            pools = list(pools)
            next_ptrs = list(next_ptrs)
            keys = list(keys)
            for c in range(len(lanes)):
                holding = lanes[c]['holding']
                ready = jnp.sum(holding & ~_chain_pending(lanes[c])) \
                    .astype(jnp.int32)
                stats = stats + jnp.stack(
                    [jnp.asarray(1 if c == 0 else 0, jnp.int32),
                     ready,
                     jnp.sum(holding).astype(jnp.int32) * service_every,
                     jnp.asarray(0, jnp.int32)])
            lanes, pools, next_ptrs, keys = _service_all(
                lanes, pools, next_ptrs, keys, geom, max_steps,
                scatter_first, use_weights,
                [int(x) for x in seg_lo[:len(lanes)]])
            return (tuple(lanes), tuple(pools), tuple(next_ptrs),
                    tuple(keys), stats)
        return body

    def make_body_dynamic(frac):
        """One walker iteration per body; each chain runs its physics
        pass under ``lax.cond``, only once enough of its holding lanes
        have drained (>= frac of the chain width, or all of them).
        Decouples the service cadence from a fixed count so lanes
        don't idle out the tail of a static window."""
        def body(carry):
            lanes, pools, next_ptrs, keys, stats = carry
            lanes = list(lanes)
            pools = list(pools)
            next_ptrs = list(next_ptrs)
            keys = list(keys)
            for c in range(len(lanes)):
                lanes[c] = body_walk(lanes[c])
            for c in range(len(lanes)):
                holding = lanes[c]['holding']
                ready = holding & ~_chain_pending(lanes[c])
                nh = jnp.sum(holding).astype(jnp.int32)
                nd = jnp.sum(ready).astype(jnp.int32)
                target = jnp.minimum(
                    jnp.int32(max(1, int(frac * holding.shape[0]))), nh)
                do_svc = (nh > 0) & (nd >= target)
                stats = stats + jnp.stack(
                    [jnp.asarray(0, jnp.int32),
                     jnp.asarray(0, jnp.int32), nh,
                     jnp.asarray(0, jnp.int32)])

                def _svc(args, c=c, nd=nd):
                    lane, pool, ptr, key, stats = args
                    stats = stats + jnp.stack(
                        [jnp.asarray(1 if c == 0 else 0, jnp.int32),
                         nd, jnp.asarray(0, jnp.int32),
                         jnp.asarray(0, jnp.int32)])
                    lane, pool, ptr, key = _service(
                        lane, pool, ptr, key, geom, max_steps,
                        scatter_first, use_weights,
                        idx_base=int(seg_lo[c]))
                    return lane, pool, ptr, key, stats

                (lanes[c], pools[c], next_ptrs[c], keys[c],
                 stats) = jax.lax.cond(
                    do_svc, _svc, lambda args: args,
                    (lanes[c], pools[c], next_ptrs[c], keys[c], stats))
            return (tuple(lanes), tuple(pools), tuple(next_ptrs),
                    tuple(keys), stats)
        return body

    def run_stage(lanes, pools, next_ptrs, keys, stats, targets):
        """Run until every chain drains (or, with per-chain lane
        ``targets``, until each active chain's pool segment is dry and
        few enough lanes remain to compact)."""
        def cond(carry):
            lanes, pools, next_ptrs, kk, stats = carry
            go = None
            for c in range(len(lanes)):
                active = jnp.any(lanes[c]['holding'])
                if targets is None:
                    more = active
                else:
                    nhold = jnp.sum(lanes[c]['holding'].astype(jnp.int32))
                    seg_n = pools[c].shape[0]
                    more = active & ((next_ptrs[c] < seg_n)
                                     | (nhold > targets[c]))
                go = more if go is None else (go | more)
            return go

        if sfrac is not None:
            body_fn = make_body_dynamic(sfrac)
        else:
            body_fn = make_body()
        return jax.lax.while_loop(
            cond, body_fn,
            (tuple(lanes), tuple(pools), tuple(next_ptrs), tuple(keys),
             stats))

    carry = (lanes, pools, next_ptrs, keys, stats)
    if min(w_c) * nchains > 4096 and len(DRAIN_SHRINK):
        for shrink in DRAIN_SHRINK:
            # shrink factors are relative to each chain's ORIGINAL
            # width (w/8 then w/64, as the single-chain driver did)
            targets = [max(w_c[c] // shrink, 1024 // nchains)
                       for c in range(nchains)]
            carry = run_stage(*carry, targets)
            lanes, pools, next_ptrs, keys, stats = carry
            lanes = tuple(_compact_lanes(lanes[c], targets[c])
                          for c in range(nchains))
            carry = (lanes, pools, next_ptrs, keys, stats)
    lanes, pools, next_ptrs, keys, stats = run_stage(*carry, None)

    stats = stats.at[3].set(sum(lane['nactive'] for lane in lanes))
    return jnp.concatenate(pools, axis=0), caller_index, stats


@jax.jit
def _unpack_out(packed, caller_index):
    out = _unpack(packed)
    out['index'] = caller_index
    return out


def propagate_fused(state, geom, key, **kw):
    """Propagate all photons in ``state`` to termination, fused; see
    ``_propagate_fused_packed`` for the driver and every knob.

    The final u32 -> f32 unpack runs in its OWN jit on purpose: fused
    into the driver graph, XLA may flush or canonicalize subnormal /
    NaN-payload float patterns riding the packed pool words (the
    referee's terminal-passthrough check catches that).  As a
    standalone bitcast-and-slice kernel the unpack is bit-exact."""
    packed, caller_index, stats = _propagate_fused_packed(
        state, geom, key, **kw)
    return _unpack_out(packed, caller_index), stats
