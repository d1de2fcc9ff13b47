"""Marginal cost of an extra row gather inside the real walker body.

Runs K fixed iterations of the production walker on the full-demo
table (no cond, no service), then the same loop with 1..3 EXTRA
independent row gathers folded into a carried checksum.  The marginal
time of an extra gather tells whether row fetches are serialized with
the body's arithmetic (marginal ~ full gather cost) or hidden under it
(marginal ~ 0) — this decides whether software pipelining can pay.

Usage: PYTHONPATH=. python tools/profile_walkgather.py \
    [tiny|full] [log2_width ...]
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import gpu
from chroma_jax.benchmark import _isotropic_photons, _sync
from chroma_jax.ops import mbvh
from chroma_jax.cache import enable_jax_cache

enable_jax_cache()

# amortize the per-call dispatch over enough iterations that
# per-iteration figures are real
K = int(os.environ.get('WALKGATHER_K', 512))


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    widths = [1 << int(x) for x in sys.argv[2:]] or [8192]
    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    for N in widths:
        print(f'== width {N} ==', flush=True)
        run_width(geom, N)


def run_width(geom, N):
    depth = min(geom.mbvh_depth, mbvh.MAX_LEVELS)
    rows = geom.mbvh_rows
    R = rows.shape[0]

    ph = _isotropic_photons(N)
    pos = jnp.asarray(ph.pos)
    dirv = jnp.asarray(ph.dir)
    inv = 1.0 / dirv
    noid = -pos * inv
    masks, bases, tcodes = mbvh.root_seed(
        geom, depth, inv, noid, jnp.ones(N, bool))

    def make_state():
        return dict(
            masks=masks, bases=bases, tcodes=tcodes,
            best_tri=jnp.full(N, -1, jnp.int32),
            min_dist=jnp.full(N, jnp.inf, jnp.float32),
            best_norm=jnp.zeros((N, 3), jnp.float32),
            best_mat=jnp.zeros(N, jnp.uint32),
            org=pos, dir=dirv, inv_dir=inv, noid=noid,
            lht=jnp.full(N, -1, jnp.int32),
            iters=jnp.zeros((), jnp.int32),
            chk=jnp.zeros(N, jnp.uint32),
            dummy_ptr=(jnp.arange(N, dtype=jnp.uint32)
                       * jnp.uint32(2654435761)) % jnp.uint32(R),
            **mbvh.extra_state(geom, N),
        )

    body = mbvh._walk_body(geom, depth)

    def run(extra, reseed_on_drain=True):
        def step(s):
            s = body(s)
            for e in range(extra):
                # independent random-row gather; fold all words into
                # the carried checksum so nothing is sliced away
                ptr = (s['dummy_ptr']
                       + jnp.uint32((0x9E3779B9 * (e + 1)) & 0xFFFFFFFF))\
                    % jnp.uint32(R)
                row = rows[ptr]
                s = dict(s, chk=s['chk']
                         ^ jax.lax.reduce(row, jnp.uint32(0),
                                          jax.lax.bitwise_xor, [1]),
                         dummy_ptr=ptr + 1)
            # keep lanes busy: when a lane's walk drains, reseed it
            done = ~jnp.any(s['masks'] != 0, axis=(1, 2))
            if reseed_on_drain:
                sm, sb, st = mbvh.root_seed(geom, depth, s['inv_dir'],
                                            s['noid'], done)
                s = dict(
                    s,
                    masks=jnp.where(done[:, None, None], sm, s['masks']),
                    bases=jnp.where(done[:, None], sb, s['bases']),
                    tcodes=jnp.where(done[:, None, None], st,
                                     s['tcodes']),
                    best_tri=jnp.where(done, -1, s['best_tri']),
                    min_dist=jnp.where(done, jnp.inf, s['min_dist']))
            return s

        @jax.jit
        def loop(s):
            return jax.lax.fori_loop(0, K, lambda i, s: step(s), s)

        s0 = make_state()
        out = loop(s0)
        _sync(out['chk'])
        ts = []
        for _ in range(3):
            t0 = time.time()
            out = loop(s0)
            _sync(out['chk'])
            ts.append(time.time() - t0)
        t = min(ts) / K
        return t

    t0 = run(0)
    print(f'body alone      : {t0*1e6:8.1f} us/iter '
          f'({t0/N*1e9:5.1f} ns/lane)', flush=True)
    for e in (1, 2, 3):
        te = run(e)
        print(f'body + {e} gather: {te*1e6:8.1f} us/iter '
              f'(marginal {(te-t0)/e*1e6:6.1f} us/gather, '
              f'{(te-t0)/e/N*1e9:5.1f} ns/row)', flush=True)


if __name__ == '__main__':
    main()
