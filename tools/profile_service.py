"""Break down the fused-driver service-pass cost on the real chip.

Times, at lane width W (default 32768), amortized in fori loops:
  S1  jax.random.uniform (W, 18)            — the per-service draws
  S2  one scalar 1D gather (W,) from a small flat table
  S3  a pair gather base/base+1 (= one _interp's memory traffic)
  S4  full physics_update on a mid-flight state
  S5  refill traffic: 10 field gathers + 10 scatters at (N,) pool
  S6  root_seed slab test
Usage: python tools/profile_service.py [tiny|full] [log2_w]
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import gpu, event
from chroma_jax.benchmark import _isotropic_photons, _sync
from chroma_jax.ops import mbvh as mbvh_ops
from chroma_jax.ops import photon as photon_ops
from chroma_jax.ops.propagate import physics_update, NDRAWS
from chroma_jax.ops import propagate as prop
from chroma_jax.cache import enable_jax_cache

enable_jax_cache()


def timeit(fn, number=3, warm=1):
    for _ in range(warm):
        _sync(fn())
    ts = []
    for _ in range(number):
        t0 = time.time()
        _sync(fn())
        ts.append(time.time() - t0)
    return min(ts)


# amortize the per-call dispatch over enough iterations that
# per-iteration figures are real
LOOP = int(os.environ.get('SERVICE_LOOP', 1024))


def loopit(fn_body, init):
    @jax.jit
    def run():
        return jax.lax.fori_loop(0, LOOP, fn_body, init)
    return run


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    wlog = int(sys.argv[2]) if len(sys.argv) > 2 else 15
    W = 1 << wlog

    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    print(f'# detector={which} W={W}', flush=True)

    key0 = jax.random.PRNGKey(0)

    # S1: draws
    def s1(i, carry):
        key, acc = carry
        key, sk = jax.random.split(key)
        u = jax.random.uniform(sk, (W, NDRAWS), dtype=jnp.float32)
        return key, acc + u[:, 0]
    t = timeit(loopit(s1, (key0, jnp.zeros(W))), number=2)
    print(f'S1 uniform (W,{NDRAWS}): {t/LOOP*1e3:8.3f} ms', flush=True)

    # S2/S3: scalar gathers from a small flat table
    flat = geom.refractive_index.reshape(-1)
    idx = jax.random.randint(key0, (W,), 0, flat.shape[0] - 1, jnp.int32)

    def s2(i, acc):
        return acc + flat[(idx + i) % (flat.shape[0] - 1)]
    t = timeit(loopit(s2, jnp.zeros(W)), number=2)
    print(f'S2 scalar gather (W,): {t/LOOP*1e3:8.3f} ms '
          f'({t/LOOP/W*1e9:.2f} ns/elem)', flush=True)

    def s3(i, acc):
        b = (idx + i) % (flat.shape[0] - 1)
        return acc + flat[b] + flat[b + 1]
    t = timeit(loopit(s3, jnp.zeros(W)), number=2)
    print(f'S3 interp pair gather: {t/LOOP*1e3:8.3f} ms', flush=True)

    # mid-flight state for realistic physics inputs
    photons = _isotropic_photons(W)
    gp = gpu.GPUPhotons(photons)
    state = {k: v for k, v in gp.state.items()}
    key = jax.random.PRNGKey(7)
    from chroma_jax.ops.propagate import propagate_step
    state = propagate_step(state, geom, key, 0)
    state = jax.tree_util.tree_map(lambda a: a.block_until_ready(), state)

    res = mbvh_ops.intersect_mesh(state['pos'], state['dir'], geom,
                                  state['last_hit_triangle'])
    res = {k: v.block_until_ready() for k, v in res.items()}

    # S4: physics_update alone
    flags = state['flags']
    active = (flags & jnp.uint32(event.TERMINAL_FLAGS)) == 0
    nan_mask = jnp.zeros(W, bool)

    def s4(i, carry):
        key, st = carry
        key, sk = jax.random.split(key)
        u = jax.random.uniform(sk, (W, NDRAWS), dtype=jnp.float32)
        st = physics_update(st, res, geom, u, st['flags'], active,
                            nan_mask, 0)
        return key, st
    t = timeit(loopit(s4, (key0, state)), number=2)
    t1 = timeit(loopit(s1, (key0, jnp.zeros(W))), number=2)
    print(f'S4 draws+physics_update: {t/LOOP*1e3:8.3f} ms '
          f'(physics alone ~{(t-t1)/LOOP*1e3:.3f} ms)', flush=True)

    # S5: refill/writeback traffic (10 gathers + 10 scatters at (4W,))
    n_pool = 4 * W
    pool = {k: jnp.concatenate([v] * 4, axis=0) for k, v in state.items()}
    lidx = jax.random.randint(key0, (W,), 0, n_pool, jnp.int32)

    def s5(i, carry):
        pool_t, acc = carry
        src = (lidx + i) % n_pool
        tot = acc
        new_pool = {}
        for k, v in pool_t.items():
            g = v[src]
            new_pool[k] = v.at[src].set(g)
            tot = tot + (g[:, 0] if g.ndim == 2 else
                         g.astype(jnp.float32) * 0)
        return new_pool, tot
    t = timeit(loopit(s5, (pool, jnp.zeros(W))), number=2)
    print(f'S5 10x gather+scatter pool fields: {t/LOOP*1e3:8.3f} ms',
          flush=True)

    # S6: root_seed
    inv_dir = 1.0 / state['dir']
    noid = -state['pos'] * inv_dir
    depth = min(geom.mbvh_depth + 1, mbvh_ops.MAX_LEVELS)

    def s6(i, acc):
        m, b, tc = mbvh_ops.root_seed(geom, depth, inv_dir, noid, active)
        return acc + m[:, 1, 0]
    t = timeit(loopit(s6, jnp.zeros(W, jnp.uint32)), number=2)
    print(f'S6 root_seed slab: {t/LOOP*1e3:8.3f} ms', flush=True)


if __name__ == '__main__':
    main()
