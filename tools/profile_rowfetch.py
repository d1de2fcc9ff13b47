"""Row-fetch micro-profile: how to hand the walker its (ROW_WIDTH, n)
transposed row block cheapest.

The walker consumes rows transposed (words on the major axis, lanes
minor).  ``rows[ptr].T`` lowers to gather + a full relayout copy
(HLO: ROOT copy u32[424,n]), an extra ~3.4 KB/lane device-memory round trip.
Variants:

  G0  rows[ptr].T                     gather + materialized transpose
  G1  lax.gather offset_dims=(0,)     gather emitting (W, n) directly
  G2  rows[ptr]                       untransposed lower bound

Each runs K dependent iterations inside one jit (the next ptr derives
from the fetched row) so dispatch latency amortizes and fetches can't
overlap across iterations.

Usage: python -m tools.profile_rowfetch [log2_n] [K]
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax.cache import enable_jax_cache

enable_jax_cache()

R, W = 16809, 424


def _sync(x):
    jax.tree_util.tree_map(lambda a: a.block_until_ready(), x)


def run(name, fetch, reduce_fn, n, K):
    rows = jnp.asarray(
        np.random.randint(0, 1 << 30, size=(R, W), dtype=np.uint32))
    ptr0 = jnp.asarray(np.random.randint(0, R, size=n, dtype=np.int32))

    @jax.jit
    def loop(ptr):
        def body(i, ptr):
            blk = fetch(rows, ptr)
            # derive the next ptr from the row content (dependence)
            s = reduce_fn(blk)
            return (ptr + s.astype(jnp.int32)) % R
        return jax.lax.fori_loop(0, K, body, ptr)

    out = loop(ptr0)
    _sync(out)
    ts = []
    for _ in range(3):
        t0 = time.time()
        out = loop(ptr0)
        _sync(out)
        ts.append(time.time() - t0)
    t = min(ts) / K
    print(f'  {name:34s} {t*1e6:8.1f} us/iter ({t/n*1e9:6.2f} ns/lane)',
          flush=True)


def main():
    n = 1 << (int(sys.argv[1]) if len(sys.argv) > 1 else 13)
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    print(f'# n={n} K={K} rows=({R},{W})', flush=True)

    dn = jax.lax.GatherDimensionNumbers(
        offset_dims=(0,), collapsed_slice_dims=(0,),
        start_index_map=(0,))

    def g1(rows, ptr):
        return jax.lax.gather(
            rows, ptr[:, None], dn, slice_sizes=(1, W),
            mode=jax.lax.GatherScatterMode.PROMISE_IN_BOUNDS)

    run('G0 rows[ptr].T (gather+copy)',
        lambda rows, ptr: rows[ptr].T,
        lambda blk: (blk[0, :] & jnp.uint32(1023)), n, K)
    run('G1 lax.gather -> (W, n) direct',
        g1,
        lambda blk: (blk[0, :] & jnp.uint32(1023)), n, K)
    run('G2 rows[ptr] (no transpose)',
        lambda rows, ptr: rows[ptr],
        lambda blk: (blk[:, 0] & jnp.uint32(1023)), n, K)
    two_streams(n, K)


def two_streams(n, K):
    """Two independent dependent-gather chains in one loop: if the
    per-iteration wall stays ~one-stream, dependent gathers overlap
    (more fused-driver chains can hide them); if it doubles, the
    gather engine serializes them and chains cannot help."""
    W_ = W
    rows = jnp.asarray(
        np.random.randint(0, 1 << 30, size=(R, W_), dtype=np.uint32))
    pa = jnp.asarray(np.random.randint(0, R, size=n, dtype=np.int32))
    pb = jnp.asarray(np.random.randint(0, R, size=n, dtype=np.int32))

    @jax.jit
    def loop(pa, pb):
        def body(i, c):
            pa, pb = c
            ra = rows[pa].T
            rb = rows[pb].T
            sa = (ra[0, :] & jnp.uint32(1023)).astype(jnp.int32)
            sb = (rb[0, :] & jnp.uint32(1023)).astype(jnp.int32)
            return ((pa + sa) % R, (pb + sb) % R)
        return jax.lax.fori_loop(0, K, body, (pa, pb))

    _sync(loop(pa, pb))
    ts = []
    for _ in range(3):
        t0 = time.time()
        _sync(loop(pa, pb))
        ts.append(time.time() - t0)
    t = min(ts) / K
    print(f'  two dependent streams              {t*1e6:8.1f} us/iter '
          f'({t/n*1e9:6.2f} ns/lane-of-{n}, '
          f'{t/(2*n)*1e9:6.2f} ns/fetched-row)', flush=True)


if __name__ == '__main__':
    main()
