"""Lock-step MBVH traversal: one fat-row gather per step.

This is the production traversal of the engine on every backend (the
narrow escape-rope walker in chroma_jax/ops/mesh.py is the validation
fallback).  Per-ray
state is a bitmask path: for each tree level, a pending-children
bitmask and the first-child row id (children are consecutive, so the
c-th pending child lives at base + c).  Every iteration:

  1. find the deepest level with pending work (predicated scan over a
     static depth — no ascend iterations, no stacks, no scatters);
  2. pop the NEAREST pending child (each pushed child carries a 16-bit
     quantized entry distance; stale children beyond the current best
     hit are lazily pruned) and gather its row — the ONLY gather of
     the step, everything else is elementwise arithmetic;
  3. cluster rows: Moller-Trumbore all BRANCH pre-assembled triangles,
     keep the closest (plus its geometric normal and material code so
     the physics step needs no further triangle fetches);
  4. internal rows: slab-test all BRANCH child AABBs (pruned against
     the best hit) and push the hit mask one level deeper.

Lock-step tails are the dominant cost (profiled on the full demo: at
64 iterations <1% of lanes still traverse, yet the uncapped loop runs
200+ iterations, every one costing the full batch width).  The walk
therefore runs as a CASCADE: a full-width stage for the typical ray,
then pending rays are compacted into an 8x narrower buffer, then a
64x one for the deep tail — sum-of-work instead of max-times-width.
Compaction is a cumsum + 1D-scatter stable partition.

All per-slot reductions use one-hot selects: fancy `[lane, idx]`
indexing would be one more XLA gather per reduction.

The reference equivalent is the per-thread stack walk of
chroma/cuda/mesh.h:41, re-expressed as whole-array XLA operations.
"""
from functools import partial

import jax
import jax.numpy as jnp

from chroma_jax.bvh.mbvh import (ROW_WIDTH, HDR_KIND, HDR_BASE, BOX_OFF,
                                 QORIGIN_OFF, QSCALE_OFF, QVERT_OFF,
                                 QVERT_WORDS_PER_COMP, TRI_ID_OFF,
                                 MAT_OFF, BRANCH, NMASK_WORDS,
                                 IBOX_ORIGIN_OFF, IBOX_SCALE_OFF,
                                 XFORM_OFF, TRI_BASE_OFF,
                                 KIND_CLUSTER, KIND_LOCAL, KIND_ENTRY)

MAX_LEVELS = 12

# cascade schedule: (iteration budget at full width, first shrink
# factor, budget at that width, second shrink factor).  The final
# stage runs to completion.  Tuned on the full-demo profile
# (tools/profile_step.py section B).
CASCADE_BUDGET_0 = 8
CASCADE_SHRINK_1 = 8
CASCADE_BUDGET_1 = 16
CASCADE_SHRINK_2 = 64
CASCADE_MIN_N = 2048          # below this, one plain loop is cheaper


def tquant_scale(geom):
    """Entry-distance quantization: 65535 / world-box diagonal.

    16-bit codes (round 3; was 8-bit) resolve ~0.3 m at the full-demo
    world size instead of ~200 mm x 400 — at 8 bits, neighboring TLAS
    leaves shared a code and nearest-first ordering/pruning degraded
    to arrival order."""
    return 65535.0 / (geom.world_scale * 65535.0 * 1.7320509)


def _walk_body(geom, depth, do_prune=True):
    """The per-iteration walker body over a traversal state dict.

    Ordered + self-pruning (round 2): every pushed child carries a
    16-bit quantized entry distance (``tcodes``).  Each iteration (a)
    lazily kills pending children whose entry distance now exceeds the
    best hit — siblings pushed before the hit was found would
    otherwise still be visited — and (b) pops the true nearest pending
    child of the deepest level instead of a Morton-end heuristic, so
    the first cluster visited almost always contains the closest hit.
    The quantization is conservative (floor on store, +1 on the prune
    threshold), so results stay exact."""
    rows = geom.mbvh_rows
    iota_d = jnp.arange(depth, dtype=jnp.int32)
    slots = jnp.arange(BRANCH, dtype=jnp.int32)
    iota32 = jnp.arange(32, dtype=jnp.uint32)
    sq = tquant_scale(geom)

    def body(s):
        masks, bases = s['masks'], s['bases']   # (n, depth, NW), (n, depth)
        tcodes = s['tcodes']                    # (n, depth, BRANCH) u16
        direction = s['dir']
        origin = s['org']
        inv_dir = s['inv_dir']
        neg_origin_inv_dir = s['noid']
        min_dist = s['min_dist']

        if do_prune:
            # lazy prune: a pending child whose quantized entry
            # distance exceeds the current best hit can never improve
            # it (alternate iterations skip this — the prune pays for
            # itself at half cadence)
            mdc = jnp.clip(jnp.floor(min_dist * sq) + 1.0, 0.0,
                           65535.0)
            keep = tcodes <= mdc[:, None, None].astype(jnp.uint16)
            keep_bits = jnp.sum(
                jnp.where(
                    keep.reshape(keep.shape[0], depth, NMASK_WORDS, 32),
                    jnp.uint32(1) << iota32[None, None, None, :],
                    jnp.uint32(0)), axis=3)
            masks = masks & keep_bits

        # deepest level with pending children (predicated scan)
        pending = jnp.any(masks != 0, axis=2)        # (n, depth)
        active = jnp.any(pending, axis=1)
        lvl = jnp.max(jnp.where(pending, iota_d[None, :], -1), axis=1)
        onehot = iota_d[None, :] == lvl[:, None]

        mask_l = jnp.sum(jnp.where(onehot[:, :, None], masks, 0),
                         axis=1)                     # (n, NW)
        base_l = jnp.sum(jnp.where(onehot, bases, 0), axis=1)
        tc_l = jnp.sum(jnp.where(onehot[:, :, None], tcodes, 0),
                       axis=1).astype(jnp.int32)     # (n, BRANCH)

        # pop the nearest pending child of the level
        bit_set = ((mask_l[:, :, None] >> iota32[None, None, :])
                   & jnp.uint32(1)).reshape(-1, BRANCH) != 0
        tl = jnp.where(bit_set, tc_l, 1 << 17)
        tl_min = jnp.min(tl, axis=1)
        is_min = tl == tl_min[:, None]
        oh_slot_pop = is_min & (jnp.cumsum(is_min, axis=1) == 1)
        c = jnp.sum(jnp.where(oh_slot_pop, slots[None, :], 0),
                    axis=1).astype(jnp.uint32)
        bitw128 = jnp.uint32(1) << (slots[None, :] % 32).astype(jnp.uint32)
        pat = jnp.sum(
            jnp.where(oh_slot_pop, bitw128, jnp.uint32(0)).reshape(
                -1, NMASK_WORDS, 32), axis=2)
        masks = jnp.where(onehot[:, :, None] & active[:, None, None],
                          masks ^ pat[:, None, :], masks)

        ptr = jnp.where(active, base_l + c, 0)
        row = rows[ptr]                     # THE gather, (N, ROW_WIDTH)

        hdr = row[:, HDR_KIND]
        count = (hdr >> jnp.uint32(8)).astype(jnp.int32)
        is_cluster = active & ((hdr & jnp.uint32(KIND_CLUSTER)) != 0)
        is_internal = active & ((hdr & jnp.uint32(KIND_CLUSTER)) == 0)

        # ---- instancing (static: compiled only for TLAS/BLAS
        # geometries).  Popping an instance-entry row moves the lane's
        # ray into the instance frame: local = R^T (world - T); the
        # entry's embedded children (the shared BLAS root's children)
        # and every BLAS row below them carry KIND_LOCAL and are
        # tested with the instance-frame ray.  Rigid transforms
        # preserve distances, so best-hit/tcode pruning runs in world
        # metric unchanged.
        if geom.mbvh_instanced:
            is_entry = active & ((hdr & jnp.uint32(KIND_ENTRY)) != 0)
            frame_local = (hdr & jnp.uint32(KIND_LOCAL)) != 0
            xf = [jax.lax.bitcast_convert_type(row[:, XFORM_OFF + i],
                                               jnp.float32)
                  for i in range(12)]
            omt = [s['org'][:, r] - xf[9 + r] for r in range(3)]
            iorg_new = jnp.stack(
                [xf[0 + k] * omt[0] + xf[3 + k] * omt[1]
                 + xf[6 + k] * omt[2] for k in range(3)], axis=-1)
            idir_new = jnp.stack(
                [xf[0 + k] * s['dir'][:, 0] + xf[3 + k] * s['dir'][:, 1]
                 + xf[6 + k] * s['dir'][:, 2] for k in range(3)],
                axis=-1)
            entc = is_entry[:, None]
            irot = jnp.where(entc, jnp.stack(xf[:9], axis=-1), s['irot'])
            iorg = jnp.where(entc, iorg_new, s['iorg'])
            idir = jnp.where(entc, idir_new, s['idir'])
            iinv = 1.0 / idir
            inoid = -iorg * iinv
            tri_base = jnp.where(is_entry,
                                 row[:, TRI_BASE_OFF].astype(jnp.int32),
                                 s['tri_base'])
            fl = frame_local[:, None]
            e_org = jnp.where(fl, iorg, origin)
            e_dir = jnp.where(fl, idir, direction)
            e_inv = jnp.where(fl, iinv, inv_dir)
            e_noid = jnp.where(fl, inoid, neg_origin_inv_dir)
        else:
            e_org, e_dir = origin, direction
            e_inv, e_noid = inv_dir, neg_origin_inv_dir

        # ---- cluster: Moller-Trumbore on component-wise (N,BRANCH)
        # slices of the quantized component-major vertex block — never
        # materializing (N,BRANCH,3,3) keeps the loop body's
        # intermediate memory traffic down ----------------------------
        qorigin = [jax.lax.bitcast_convert_type(
            row[:, QORIGIN_OFF + k], jnp.float32)[:, None]
            for k in range(3)]
        qscale = [jax.lax.bitcast_convert_type(
            row[:, QSCALE_OFF + k], jnp.float32)[:, None]
            for k in range(3)]

        def vcomp(j):
            w = row[:, QVERT_OFF + j * QVERT_WORDS_PER_COMP:
                    QVERT_OFF + (j + 1) * QVERT_WORDS_PER_COMP]
            lo = (w & jnp.uint32(0xFFFF)).astype(jnp.float32)
            hi = (w >> jnp.uint32(16)).astype(jnp.float32)
            # block halfword layout: slots [0..B/2) in lo, rest in hi
            # (per-component decode measured faster than one whole-
            # block decode: smaller fused intermediates win)
            q = jnp.concatenate([lo, hi], axis=1)
            k = j % 3
            return q * qscale[k] + qorigin[k]

        v0 = [vcomp(j) for j in range(3)]
        v1 = [vcomp(j) for j in range(3, 6)]
        v2 = [vcomp(j) for j in range(6, 9)]
        d = [e_dir[:, k:k + 1] for k in range(3)]
        o = [e_org[:, k:k + 1] for k in range(3)]
        e1 = [v1[k] - v0[k] for k in range(3)]
        e2 = [v2[k] - v0[k] for k in range(3)]

        def cross3(a, b):
            return [a[1] * b[2] - a[2] * b[1],
                    a[2] * b[0] - a[0] * b[2],
                    a[0] * b[1] - a[1] * b[0]]

        def dot3(a, b):
            return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

        h = cross3(d, e2)
        a = dot3(e1, h)
        not_par = jnp.abs(a) > 1.1920929e-07
        f = 1.0 / jnp.where(not_par, a, 1.0)
        sv = [o[k] - v0[k] for k in range(3)]
        u_b = f * dot3(sv, h)
        q = cross3(sv, e1)
        v_b = f * dot3(d, q)
        t_d = f * dot3(e2, q)
        eps = 1e-6
        t_hit = (not_par & (u_b >= -eps) & (u_b <= 1.0 + eps)
                 & (v_b >= -eps) & (u_b + v_b <= 1.0 + eps) & (t_d > eps))

        tri_ids = row[:, TRI_ID_OFF:TRI_ID_OFF + BRANCH].astype(jnp.int32)
        if geom.mbvh_instanced:
            # BLAS cluster rows carry LOCAL triangle ids; the entry's
            # carried base maps them to global (flattened-mesh) ids
            tri_ids = tri_ids + jnp.where(frame_local, tri_base,
                                          0)[:, None]
        valid = (t_hit & (slots[None, :] < count[:, None])
                 & (tri_ids != s['lht'][:, None]))
        t_dist = jnp.where(valid, t_d, jnp.inf)
        cl_dist = jnp.min(t_dist, axis=1)
        # one-hot of the FIRST minimal slot (ties broken like argmin)
        is_min = t_dist == cl_dist[:, None]
        oh_slot = is_min & (jnp.cumsum(is_min, axis=1) == 1)

        improved = is_cluster & (cl_dist < s['min_dist'])
        norm_c = cross3(e1, e2)

        def pick(arr):
            return jnp.sum(jnp.where(oh_slot, arr, 0), axis=1)

        def pickf(arr):
            return jnp.sum(jnp.where(oh_slot, arr, 0.0), axis=1)

        best_tri = jnp.where(improved, pick(tri_ids), s['best_tri'])
        min_dist = jnp.where(improved, cl_dist, s['min_dist'])
        nl = [pickf(norm_c[0]), pickf(norm_c[1]), pickf(norm_c[2])]
        if geom.mbvh_instanced:
            # geometric normals of BLAS triangles are in the instance
            # frame: rotate back to world (n_w = R n_l) at record time
            # — later instance entries overwrite irot
            nw = [irot[:, 3 * r + 0] * nl[0] + irot[:, 3 * r + 1] * nl[1]
                  + irot[:, 3 * r + 2] * nl[2] for r in range(3)]
            nl = [jnp.where(frame_local, nw[k], nl[k]) for k in range(3)]
        norm_new = jnp.stack(nl, axis=-1)
        best_norm = jnp.where(improved[:, None], norm_new, s['best_norm'])
        mats = row[:, MAT_OFF:MAT_OFF + BRANCH]
        best_mat = jnp.where(improved,
                             pick(mats.astype(jnp.int32)).astype(
                                 jnp.uint32),
                             s['best_mat'])

        # ---- internal: slab-test all child boxes (component-major
        # box words: contiguous per-axis slices, decoded lazily with
        # the ROW-CARRIED grid constants — TLAS rows use the world
        # grid, BLAS rows their own local grid) -----------------------
        tmin = None
        tmax = None
        for k in range(3):
            pk = row[:, BOX_OFF + k * BRANCH:BOX_OFF + (k + 1) * BRANCH]
            bo = jax.lax.bitcast_convert_type(
                row[:, IBOX_ORIGIN_OFF + k], jnp.float32)[:, None]
            bs = jax.lax.bitcast_convert_type(
                row[:, IBOX_SCALE_OFF + k], jnp.float32)[:, None]
            lok = bo + (pk & jnp.uint32(0xFFFF)).astype(jnp.float32) * bs
            hik = bo + (pk >> jnp.uint32(16)).astype(jnp.float32) * bs
            t0 = lok * e_inv[:, k:k + 1] + e_noid[:, k:k + 1]
            t1 = hik * e_inv[:, k:k + 1] + e_noid[:, k:k + 1]
            finite = jnp.isfinite(e_inv[:, k:k + 1])
            small = jnp.where(finite, jnp.minimum(t0, t1), -jnp.inf)
            big = jnp.where(finite, jnp.maximum(t0, t1), jnp.inf)
            tmin = small if tmin is None else jnp.maximum(tmin, small)
            tmax = big if tmax is None else jnp.minimum(tmax, big)
        tmin = jnp.maximum(tmin, 0.0)
        b_ok = (tmin <= tmax) & (tmin <= min_dist[:, None]) \
            & (slots[None, :] < count[:, None])
        bitw = (jnp.uint32(1)
                << (slots[None, :] % 32).astype(jnp.uint32))
        hitmask = jnp.sum(
            jnp.where(b_ok, bitw, jnp.uint32(0)).reshape(
                -1, NMASK_WORDS, 32), axis=2).astype(jnp.uint32)

        push = is_internal & jnp.any(hitmask != 0, axis=1) \
            & (lvl + 1 < depth)
        onehot_child = iota_d[None, :] == (lvl + 1)[:, None]
        sel = onehot_child & push[:, None]
        masks = jnp.where(sel[:, :, None], hitmask[:, None, :], masks)
        bases = jnp.where(sel, row[:, HDR_BASE][:, None], bases)
        newcodes = jnp.where(
            b_ok, jnp.clip(jnp.floor(tmin * sq), 0.0, 65534.0),
            65535.0).astype(jnp.uint16)
        tcodes = jnp.where(sel[:, :, None], newcodes[:, None, :], tcodes)

        out = dict(s)
        out.update(masks=masks, bases=bases, tcodes=tcodes,
                   best_tri=best_tri,
                   min_dist=min_dist, best_norm=best_norm,
                   best_mat=best_mat, iters=s['iters'] + 1)
        if geom.mbvh_instanced:
            out.update(irot=irot, iorg=iorg, idir=idir,
                       tri_base=tri_base)
        if 'nactive' in s:      # profiling accumulator (ops/fused.py)
            out['nactive'] = s['nactive'] \
                + jnp.sum(active.astype(jnp.int32)).astype(jnp.int32)
        return out

    return body


def root_seed(geom, depth, inv_dir, noid, active):
    """Seed (masks, bases) with the ROOT row's child slab-test done
    inline.  The root row is identical for every lane, so testing its
    BRANCH child boxes is pure arithmetic on a broadcast constant — it
    saves one row gather AND one full-width walker iteration per
    traversal (every photon step pays the root visit otherwise).

    Falls back to classic level-0 seeding when the root is a cluster
    row (meshes with <= BRANCH triangles, geom.mbvh_depth == 1)."""
    n = inv_dir.shape[0]
    masks = jnp.zeros((n, depth, NMASK_WORDS), jnp.uint32)
    bases = jnp.zeros((n, depth), jnp.uint32)
    tcodes = jnp.full((n, depth, BRANCH), 65535, jnp.uint16)
    if geom.mbvh_depth < 2 or depth < 2:
        return (masks.at[:, 0, 0].set(active.astype(jnp.uint32)),
                bases, tcodes.at[:, 0, 0].set(0))

    root = geom.mbvh_rows[0]                    # static slice, no gather
    slots = jnp.arange(BRANCH, dtype=jnp.int32)
    tmin = None
    tmax = None
    for k in range(3):
        pk = root[BOX_OFF + k * BRANCH:BOX_OFF + (k + 1) * BRANCH][None, :]
        bo = jax.lax.bitcast_convert_type(root[IBOX_ORIGIN_OFF + k],
                                          jnp.float32)
        bs = jax.lax.bitcast_convert_type(root[IBOX_SCALE_OFF + k],
                                          jnp.float32)
        lok = bo + (pk & jnp.uint32(0xFFFF)).astype(jnp.float32) * bs
        hik = bo + (pk >> jnp.uint32(16)).astype(jnp.float32) * bs
        t0 = lok * inv_dir[:, k:k + 1] + noid[:, k:k + 1]
        t1 = hik * inv_dir[:, k:k + 1] + noid[:, k:k + 1]
        finite = jnp.isfinite(inv_dir[:, k:k + 1])
        small = jnp.where(finite, jnp.minimum(t0, t1), -jnp.inf)
        big = jnp.where(finite, jnp.maximum(t0, t1), jnp.inf)
        tmin = small if tmin is None else jnp.maximum(tmin, small)
        tmax = big if tmax is None else jnp.minimum(tmax, big)
    tmin = jnp.maximum(tmin, 0.0)
    count = (root[HDR_KIND] >> jnp.uint32(8)).astype(jnp.int32)
    b_ok = (tmin <= tmax) & (slots[None, :] < count) \
        & active[:, None]
    bitw = jnp.uint32(1) << (slots[None, :] % 32).astype(jnp.uint32)
    hitmask = jnp.sum(
        jnp.where(b_ok, bitw, jnp.uint32(0)).reshape(
            n, NMASK_WORDS, 32), axis=2).astype(jnp.uint32)
    masks = masks.at[:, 1, :].set(hitmask)
    bases = bases.at[:, 1].set(root[HDR_BASE])
    sq = tquant_scale(geom)
    codes = jnp.where(b_ok,
                      jnp.clip(jnp.floor(tmin * sq), 0.0, 65534.0),
                      65535.0).astype(jnp.uint16)
    tcodes = tcodes.at[:, 1, :].set(codes)
    return masks, bases, tcodes


def extra_state(geom, n):
    """Per-lane walker state that only instanced geometries carry: the
    current instance's rotation, instance-frame ray, and global
    triangle-id base.  The fields are only read for rows marked
    KIND_LOCAL, which are only reachable after an instance-entry pop
    set them, so zero-initialization is safe."""
    if not geom.mbvh_instanced:
        return {}
    return dict(irot=jnp.zeros((n, 9), jnp.float32),
                iorg=jnp.zeros((n, 3), jnp.float32),
                idir=jnp.ones((n, 3), jnp.float32),
                tri_base=jnp.zeros(n, jnp.int32))


UNROLL = 4          # walker bodies per loop boundary: the fixed cost
                    # per while_loop iteration dominates narrow
                    # stages, so amortize it (finished lanes do inert
                    # row-0 work inside an unroll group)


def _run_stage(state, body, budget, target=None):
    """Run the walker until everyone is done, the stage budget is
    exhausted AND (if given) at most ``target`` rays remain pending."""
    start = state['iters']

    def cond(s):
        pending = jnp.any(s['masks'] != 0, axis=(1, 2))
        more = jnp.any(pending)
        in_budget = (s['iters'] - start) < budget
        if target is None:
            return more & in_budget
        return more & (in_budget
                       | (jnp.sum(pending.astype(jnp.int32)) > target))

    def body_unrolled(s):
        for _ in range(UNROLL):
            s = body(s)
        return s

    return jax.lax.while_loop(cond, body_unrolled, state)


def _compact(state, m):
    """Stable-partition pending rays to the front; return the first
    ``m`` lanes as a new state plus the source indices for scatter
    -back.  Extra lanes (when fewer than m are pending) carry finished
    rays whose empty masks make them inert."""
    n = state['masks'].shape[0]
    pending = jnp.any(state['masks'] != 0, axis=(1, 2))
    cnt = jnp.cumsum(pending.astype(jnp.int32))
    total = cnt[-1]
    rank_n = jnp.cumsum((~pending).astype(jnp.int32)) - 1
    dest = jnp.where(pending, cnt - 1, total + rank_n)
    src = jnp.zeros(n, jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32))
    idx = src[:m]
    sub = {k: (v if k == 'iters' else v[idx]) for k, v in state.items()}
    return sub, idx


_RESULT_KEYS = ('best_tri', 'min_dist', 'best_norm', 'best_mat', 'masks')


def _scatter_back(state, sub, idx):
    out = dict(state)
    for k in _RESULT_KEYS:
        out[k] = state[k].at[idx].set(sub[k])
    out['iters'] = sub['iters']
    return out


@partial(jax.jit, static_argnames=('max_iters',))
def intersect_mesh(origin, direction, geom, last_hit_triangle=None,
                   active=None, max_iters=65536):
    """Closest-hit intersection against the MBVH (the cascade walker
    above).

    Args:
      origin, direction: (N,3) f32, direction normalized.
      geom: GeometryTables (with mbvh_rows).
      last_hit_triangle: (N,) i32 triangle to skip, or None.

    Returns dict with:
      triangle: (N,) i32 (-1 = miss)
      distance: (N,) f32 (inf on miss)
      normal:   (N,3) f32 geometric normal (unnormalized cross product)
      material_code: (N,) u32 packed material/surface code
      incomplete: (N,) bool rays stopped by max_iters (callers retry)
    """
    n = origin.shape[0]
    if last_hit_triangle is None:
        last_hit_triangle = jnp.full(n, -1, jnp.int32)

    depth = min(geom.mbvh_depth, MAX_LEVELS)

    if active is None:
        active = jnp.ones(n, bool)
    inv_dir = 1.0 / direction
    noid = -origin * inv_dir
    masks, bases, tcodes = root_seed(geom, depth, inv_dir, noid, active)
    state = dict(
        masks=masks,
        bases=bases,
        tcodes=tcodes,
        best_tri=jnp.full(n, -1, jnp.int32),
        min_dist=jnp.full(n, jnp.inf, jnp.float32),
        best_norm=jnp.zeros((n, 3), jnp.float32),
        best_mat=jnp.zeros(n, jnp.uint32),
        org=origin,
        dir=direction,
        inv_dir=inv_dir,
        noid=noid,
        lht=last_hit_triangle,
        iters=jnp.zeros((), jnp.int32),
        **extra_state(geom, n),
    )
    body = _walk_body(geom, depth)

    use_cascade = (n >= CASCADE_MIN_N and max_iters > CASCADE_BUDGET_0
                   + CASCADE_BUDGET_1)
    if not use_cascade:
        out = _run_stage(state, body, max_iters)
    else:
        m1 = n // CASCADE_SHRINK_1
        m2 = max(n // CASCADE_SHRINK_2, 256)
        # stage 0: full width for the typical ray; keep going past the
        # budget if more than m1 rays still need the tree
        state = _run_stage(state, body, CASCADE_BUDGET_0, target=m1)
        sub1, idx1 = _compact(state, m1)
        sub1 = _run_stage(sub1, body, CASCADE_BUDGET_1, target=m2)
        sub2, idx2 = _compact(sub1, m2)
        sub2 = _run_stage(sub2, body, max_iters)
        sub1 = _scatter_back(sub1, sub2, idx2)
        out = _scatter_back(state, sub1, idx1)

    # rays stopped by max_iters still have pending work: their partial
    # result must not be trusted (callers retry them)
    incomplete = jnp.any(out['masks'] != 0, axis=(1, 2))
    return dict(triangle=out['best_tri'], distance=out['min_dist'],
                normal=out['best_norm'], material_code=out['best_mat'],
                incomplete=incomplete)
