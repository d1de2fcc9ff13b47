"""Microbenchmarks for the MBVH gather cost model on the device.

Questions this answers (ARCHITECTURE.md cost-model v3):
  G1  ns/row vs row width (760B .. 27KB) — where does the flat
      latency-bound regime end?
  G2  do INDEPENDENT gathers in one loop body overlap?  (k parallel
      gathers of N/k rows vs 1 gather of N rows)
  G3  one-hot matmul as a gather replacement for small tables
      (level-1 of the tree: <=512 rows) — matmul vs gather.
  G4  gather cost at small N (does ns/row rise when the batch is
      narrow, i.e. how expensive are trickle stages really?)

Usage: python tools/profile_gather.py [sections]   (default: all)
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp


def _sync(x):
    jax.block_until_ready(x)
    leaf = jax.tree_util.tree_leaves(x)[0]
    np.asarray(leaf[:1] if getattr(leaf, 'ndim', 0) else leaf)


def timeit(fn, number=3, warm=1):
    for _ in range(warm):
        _sync(fn())
    ts = []
    for _ in range(number):
        t0 = time.time()
        _sync(fn())
        ts.append(time.time() - t0)
    return min(ts)


def log(msg):
    print(msg, flush=True)


def make_table(nrows, width_words, seed=0):
    k = jax.random.PRNGKey(seed)
    return jax.random.randint(k, (nrows, width_words), 0, 2**31 - 1,
                              dtype=jnp.int32).astype(jnp.uint32)


# amortize the per-call dispatch over enough in-loop iterations that
# per-iteration figures are real.
LOOP = int(os.environ.get('GATHER_LOOP', 8))
INNER = int(os.environ.get('GATHER_INNER', 64))


def g1_width():
    ng = 1 << 19
    kk = jax.random.PRNGKey(1)
    for words in (190, 840, 1680, 3360, 6720):
        nrows = max((1 << 31) // (words * 4), 1)   # ~2 GiB table
        nrows = min(nrows, 1 << 20)
        rows = make_table(nrows, words)

        @jax.jit
        def g(rows, ptr):
            def body(i, acc):
                r = rows[(ptr + i) % rows.shape[0]]
                return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
            return jax.lax.fori_loop(0, LOOP, body,
                                     jnp.zeros((), jnp.uint32))

        ptr = jax.random.randint(kk, (ng,), 0, nrows, dtype=jnp.int32)
        ptr.block_until_ready()
        t = timeit(lambda: g(rows, ptr), number=2)
        per = t / (ng * LOOP) * 1e9
        log(f'G1 width={words*4:6d}B rows={nrows:8d}: {per:6.2f} ns/row'
            f'  ({words*4/per:.0f} GB/s)')
        del rows


def g2_parallel():
    words = 840
    nrows = 1 << 19
    rows = make_table(nrows, words)
    ng = 1 << 19
    kk = jax.random.PRNGKey(2)
    for k in (1, 2, 4):
        m = ng // k
        ptrs = [jax.random.randint(jax.random.fold_in(kk, i), (m,), 0,
                                   nrows, dtype=jnp.int32)
                for i in range(k)]

        @jax.jit
        def g(rows, *ptrs):
            def body(i, acc):
                s = acc
                for p in ptrs:
                    r = rows[(p + i) % nrows]
                    s = s + jnp.sum(r[:, :4].astype(jnp.uint32))
                return s
            return jax.lax.fori_loop(0, LOOP, body,
                                     jnp.zeros((), jnp.uint32))

        for p in ptrs:
            p.block_until_ready()
        t = timeit(lambda: g(rows, *ptrs), number=2)
        per = t / (ng * LOOP) * 1e9
        log(f'G2 k={k} parallel gathers of {m} rows: {per:6.2f} ns/row')


def g3_onehot():
    ng = 1 << 16
    kk = jax.random.PRNGKey(3)
    for nrows in (128, 512):
        words = 840
        rows = make_table(nrows, words)
        # exact byte-level bf16 table: (nrows, words*4) in [0,255]
        byt = jnp.concatenate(
            [((rows >> (8 * b)) & jnp.uint32(0xFF)).astype(jnp.bfloat16)
             for b in range(4)], axis=1)
        ptr = jax.random.randint(kk, (ng,), 0, nrows, dtype=jnp.int32)

        @jax.jit
        def g_gather(rows, ptr):
            def body(i, acc):
                r = rows[(ptr + i) % nrows]
                return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
            return jax.lax.fori_loop(0, LOOP, body,
                                     jnp.zeros((), jnp.uint32))

        @jax.jit
        def g_onehot(byt, ptr):
            def body(i, acc):
                oh = ((ptr + i) % nrows)[:, None] == jnp.arange(
                    nrows, dtype=jnp.int32)[None, :]
                r = jnp.dot(oh.astype(jnp.bfloat16), byt,
                            preferred_element_type=jnp.float32)
                return acc + jnp.sum(r[:, :4])
            return jax.lax.fori_loop(0, LOOP, body,
                                     jnp.zeros((), jnp.float32))

        ptr.block_until_ready()
        t1 = timeit(lambda: g_gather(rows, ptr), number=2)
        t2 = timeit(lambda: g_onehot(byt, ptr), number=2)
        log(f'G3 nrows={nrows}: gather {t1/(ng*LOOP)*1e9:6.2f} ns/row, '
            f'one-hot matmul {t2/(ng*LOOP)*1e9:6.2f} ns/row')


def g4_narrow():
    words = 840
    nrows = 1 << 19
    rows = make_table(nrows, words)
    kk = jax.random.PRNGKey(4)
    for lg in (12, 14, 16, 19):
        ng = 1 << lg

        @jax.jit
        def g(rows, ptr):
            def body(i, acc):
                r = rows[(ptr + i) % nrows]
                return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
            return jax.lax.fori_loop(0, INNER, body,
                                     jnp.zeros((), jnp.uint32))

        ptr = jax.random.randint(kk, (ng,), 0, nrows, dtype=jnp.int32)
        ptr.block_until_ready()
        t = timeit(lambda: g(rows, ptr), number=2)
        per = t / (ng * INNER) * 1e9
        log(f'G4 n={ng:7d}: {per:6.2f} ns/row '
            f'({t/INNER*1e6:7.1f} us/iter)')


def g5_real_table():
    """Realistic MBVH-table gather: R=12308 rows (the instanced full
    demo), width swept 256B..3.4KB, n=16384 lanes — what would
    narrower rows actually cost per row?"""
    nrows = 12308
    ng = 1 << 14
    kk = jax.random.PRNGKey(5)
    for words in (64, 128, 160, 224, 420, 840):
        rows = make_table(nrows, words)

        @jax.jit
        def g(rows, ptr):
            def body(i, acc):
                r = rows[(ptr + i * 37) % nrows]
                return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
            return jax.lax.fori_loop(0, INNER, body,
                                     jnp.zeros((), jnp.uint32))

        ptr = jax.random.randint(kk, (ng,), 0, nrows, dtype=jnp.int32)
        ptr.block_until_ready()
        t = timeit(lambda: g(rows, ptr), number=3)
        per = t / (ng * INNER) * 1e9
        log(f'G5 width={words*4:6d}B: {per:6.2f} ns/row '
            f'({words*4/per:.0f} GB/s, {t/INNER*1e6:7.1f} us/pass)')
        del rows


def g6_lanes():
    """ns/row vs lane count on the realistic 12308-row table — is
    there a fixed per-pass cost that wider batches amortize?"""
    nrows = 12308
    kk = jax.random.PRNGKey(6)
    for words in (224, 840):
        rows = make_table(nrows, words)
        for lg in (12, 14, 16, 18, 20):
            ng = 1 << lg

            @jax.jit
            def g(rows, ptr):
                def body(i, acc):
                    r = rows[(ptr + i * 37) % nrows]
                    return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
                return jax.lax.fori_loop(0, INNER, body,
                                         jnp.zeros((), jnp.uint32))

            ptr = jax.random.randint(kk, (ng,), 0, nrows,
                                     dtype=jnp.int32)
            ptr.block_until_ready()
            t = timeit(lambda: g(rows, ptr), number=3)
            per = t / (ng * INNER) * 1e9
            log(f'G6 width={words*4:5d}B n={ng:8d}: {per:6.2f} ns/row '
                f'({t/INNER*1e6:8.1f} us/pass)')
        del rows


def main():
    sections = sys.argv[1] if len(sys.argv) > 1 else '1234'
    log(f'# devices: {jax.devices()}')
    if '1' in sections:
        g1_width()
    if '2' in sections:
        g2_parallel()
    if '3' in sections:
        g3_onehot()
    if '4' in sections:
        g4_narrow()
    if '5' in sections:
        g5_real_table()
    if '6' in sections:
        g6_lanes()


if __name__ == '__main__':
    main()
