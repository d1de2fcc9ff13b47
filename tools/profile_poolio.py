"""Micro-profile of pool retire/refill primitives.

The pool scatter+gather is a large share of the fused driver's service
pass.  This tool measures the primitives in isolation to pick a faster
writeback:

  gather N rows            pool[idx]                (refill side)
  scatter N rows           pool.at[idx].set(rows)   (retire side)
  scatter, sorted idx      same, indices ascending
  scatter, dense cursor    iota + cursor indices (compacted retire)
  scatter half rows        N/2 updates
  scatter via u64 view     (N, 8) u64 rows

Each runs K passes inside one jit with a serial dependency (like the
real driver).  Subtract the fixed per-iteration loop cost mentally.

Usage: python tools/profile_poolio.py [K]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), '..'))

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax.cache import enable_jax_cache

enable_jax_cache()

jax.config.update('jax_enable_x64', True)   # for the u64-view variants

N_POOL = 1 << 19        # ~half the 1M-photon pool, per chain scale x3
ROWS = 8192             # 2w at w=4096 (one chain's retire volume)


def timeit(label, fn, carry, K):
    out = fn(carry)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        out = fn(carry)
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        ts.append(time.time() - t0)
    t = min(ts) / K
    print(f'{label:22s}: {t*1e3:7.3f} ms/pass '
          f'({t/ROWS*1e9:6.1f} ns/row)', flush=True)


def main():
    K = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    pool = jnp.zeros((N_POOL, 16), jnp.uint32)
    rows = jnp.arange(ROWS * 16, dtype=jnp.uint32).reshape(ROWS, 16)
    rng = np.random.RandomState(0)
    scat = jnp.asarray(rng.choice(N_POOL, ROWS, replace=False)
                       .astype(np.int32))
    scat_sorted = jnp.sort(scat)

    def loop(body):
        @jax.jit
        def run(carry):
            return jax.lax.fori_loop(0, K, body, carry)
        return run

    timeit('gather', loop(
        lambda i, c: (c[0],
                      c[1] + c[0][(scat + i) % N_POOL].sum(
                          dtype=jnp.uint32))),
        (pool, jnp.uint32(0)), K)

    timeit('scatter random', loop(
        lambda i, c: (c[0].at[(scat + i) % N_POOL].set(
            rows + i.astype(jnp.uint32)), c[1])),
        (pool, jnp.uint32(0)), K)

    timeit('scatter sorted', loop(
        lambda i, c: (c[0].at[(scat_sorted + i) % N_POOL].set(
            rows + i.astype(jnp.uint32)), c[1])),
        (pool, jnp.uint32(0)), K)

    dense = jnp.arange(ROWS, dtype=jnp.int32)
    timeit('scatter dense cursor', loop(
        lambda i, c: (c[0].at[(dense + i * 13) % N_POOL].set(
            rows + i.astype(jnp.uint32)), c[1])),
        (pool, jnp.uint32(0)), K)

    timeit('dyn_update_slice', loop(
        lambda i, c: (jax.lax.dynamic_update_slice(
            c[0], rows + i.astype(jnp.uint32),
            ((i * 13) % (N_POOL - ROWS), 0)), c[1])),
        (pool, jnp.uint32(0)), K)

    half = ROWS // 2
    timeit('scatter half rows', loop(
        lambda i, c: (c[0].at[(scat[:half] + i) % N_POOL].set(
            rows[:half] + i.astype(jnp.uint32)), c[1])),
        (pool, jnp.uint32(0)), K)

    timeit('scatter drop-half', loop(
        lambda i, c: (c[0].at[
            jnp.where(dense % 2 == 0, (scat + i) % N_POOL, N_POOL)
        ].set(rows + i.astype(jnp.uint32), mode='drop'), c[1])),
        (pool, jnp.uint32(0)), K)

    # transposed pool: scatter columns of a (16, N) array
    poolT = jnp.zeros((16, N_POOL), jnp.uint32)
    rowsT = rows.T
    timeit('scatter transposed', loop(
        lambda i, c: (c[0].at[:, (scat + i) % N_POOL].set(
            rowsT + i.astype(jnp.uint32)), c[1])),
        (poolT, jnp.uint32(0)), K)

    # u64 view: half the row elements (same 64 B/row) — tests whether
    # the scatter cost is per-element or per-row
    pool64 = jnp.zeros((N_POOL, 8), jnp.uint64)
    rows64 = jax.lax.bitcast_convert_type(
        rows.reshape(ROWS, 8, 2), jnp.uint64)
    timeit('scatter u64 view', loop(
        lambda i, c: (c[0].at[(scat + i) % N_POOL].set(
            rows64 + jnp.uint64(1)), c[1])),
        (pool64, jnp.uint32(0)), K)

    timeit('gather u64 view', loop(
        lambda i, c: (c[0],
                      c[1] + c[0][(scat + i) % N_POOL].sum(
                          dtype=jnp.uint64).astype(jnp.uint32))),
        (pool64, jnp.uint32(0)), K)

    # operand-size dependence: gather/scatter on a staging-sized
    # operand (2w rows).  If small-operand row IO is much cheaper, the
    # pool IO can be staged: contiguous dynamic_slice from the pool +
    # small distribute-gather (refill); small compact + contiguous
    # dynamic_update_slice (retire).
    small = jnp.arange(2 * ROWS * 16, dtype=jnp.uint32) \
        .reshape(2 * ROWS, 16)
    sidx = jnp.asarray(np.random.RandomState(1)
                       .choice(2 * ROWS, ROWS, replace=False)
                       .astype(np.int32))
    timeit('gather small operand', loop(
        lambda i, c: (c[0],
                      c[1] + small[(sidx + i) % (2 * ROWS)].sum(
                          dtype=jnp.uint32))),
        (pool, jnp.uint32(0)), K)

    stag = jnp.zeros((2 * ROWS, 16), jnp.uint32)
    timeit('scatter small operand', loop(
        lambda i, c: (c[0].at[(sidx + i) % (2 * ROWS)].set(
            rows + i.astype(jnp.uint32)), c[1])),
        (stag, jnp.uint32(0)), K)

    # staged refill: contiguous slice from the big pool + small
    # distribute-gather — the replacement candidate for `pool[idx]`
    timeit('staged refill', loop(
        lambda i, c: (c[0],
                      c[1] + jax.lax.dynamic_slice(
                          c[0], ((i * 13) % (N_POOL - 2 * ROWS), 0),
                          (2 * ROWS, 16))[(sidx + i) % (2 * ROWS)].sum(
                              dtype=jnp.uint32))),
        (pool, jnp.uint32(0)), K)


def extra():
    """unique/sorted scatter flag variants (r5 follow-up)."""
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    pool = jnp.zeros((N_POOL, 16), jnp.uint32)
    rows = jnp.arange(ROWS * 16, dtype=jnp.uint32).reshape(ROWS, 16)
    rng = np.random.RandomState(0)
    scat = jnp.asarray(rng.choice(N_POOL, ROWS, replace=False)
                       .astype(np.int32))
    scat_sorted = jnp.sort(scat)

    def loop(body):
        @jax.jit
        def run(carry):
            return jax.lax.fori_loop(0, K, body, carry)
        return run

    timeit('scat rand unique', loop(
        lambda i, c: (c[0].at[(scat + i) % N_POOL].set(
            rows + i.astype(jnp.uint32), unique_indices=True), c[1])),
        (pool, jnp.uint32(0)), K)

    timeit('scat sort uniq+sort', loop(
        lambda i, c: (c[0].at[jnp.minimum(scat_sorted + i,
                                          N_POOL - 1)].set(
            rows + i.astype(jnp.uint32), unique_indices=True,
            indices_are_sorted=True), c[1])),
        (pool, jnp.uint32(0)), K)

    # big one-shot scatter: per-row cost at 1M rows (the final
    # order-restore candidate)
    NBIG = 1 << 20
    big_rows = jnp.arange(NBIG * 16, dtype=jnp.uint32).reshape(NBIG, 16)
    perm = jnp.asarray(rng.permutation(NBIG).astype(np.int32))
    big_pool = jnp.zeros((NBIG, 16), jnp.uint32)

    @jax.jit
    def one_big(carry):
        pool, i = carry
        return pool.at[(perm + i) % NBIG].set(
            big_rows, unique_indices=True), i + 1
    out = one_big((big_pool, jnp.int32(0)))
    jax.block_until_ready(out[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        out = one_big((big_pool, jnp.int32(0)))
        jax.block_until_ready(out[0])
        ts.append(time.time() - t0)
    t = min(ts)
    print(f'{"1M-row scatter uniq":22s}: {t*1e3:7.3f} ms '
          f'({t/NBIG*1e9:6.1f} ns/row)', flush=True)

    # elementwise (n,) scalar scatter at 1M, for the inv-perm path
    vals = jnp.arange(NBIG, dtype=jnp.int32)
    dest = jnp.zeros(NBIG, jnp.int32)

    @jax.jit
    def inv_perm(carry):
        d, i = carry
        return d.at[(perm + i) % NBIG].set(vals, unique_indices=True), \
            i + 1
    out = inv_perm((dest, jnp.int32(0)))
    jax.block_until_ready(out[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        out = inv_perm((dest, jnp.int32(0)))
        jax.block_until_ready(out[0])
        ts.append(time.time() - t0)
    t = min(ts)
    print(f'{"1M elem scatter uniq":22s}: {t*1e3:7.3f} ms '
          f'({t/NBIG*1e9:6.1f} ns/el)', flush=True)

    # 1M-row gather (the inv-perm restore's second half)
    @jax.jit
    def big_gather(carry):
        return big_rows[(perm + carry[1]) % NBIG], carry[1] + 1
    out = big_gather((big_pool, jnp.int32(0)))
    jax.block_until_ready(out[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        out = big_gather((big_pool, jnp.int32(0)))
        jax.block_until_ready(out[0])
        ts.append(time.time() - t0)
    t = min(ts)
    print(f'{"1M-row gather":22s}: {t*1e3:7.3f} ms '
          f'({t/NBIG*1e9:6.1f} ns/row)', flush=True)


if __name__ == '__main__':
    if 'extra' in sys.argv[1:2]:
        extra()
    else:
        main()
