"""Split the service-pass physics cost (24,576 rows) into TABLE
LOOKUPS vs the ELEMENTWISE LATTICE, to ground any physics-in-kernel
estimate.

Variants, each K passes in one jit with a serial dependency:
  full        the real physics_update
  -interp     _interp/_interp_rows/_sample_icdf -> constants (no
              gathers; isolates the gather/lookup cost)
  lattice0    physics_update with BOTH interp stubs and fixed draws
  onehot      the _interp gather re-expressed as a one-hot matmul
              (matmul small-table lookup), timed in isolation
  gather      the plain flat[base] interp gather, in isolation

Usage: python tools/probe_physics_cost.py [tiny|full] [K]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), '..'))

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import gpu
from chroma_jax.benchmark import _isotropic_photons
from chroma_jax.ops import propagate as P
from chroma_jax.ops.propagate import physics_update, NDRAWS
from chroma_jax.cache import enable_jax_cache

enable_jax_cache()

N = 2 * 12288     # nsets*w_all of the production od=1 service pass


def timeit(label, fn, carry, K):
    out = fn(carry)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    ts = []
    for _ in range(3):
        t0 = time.time()
        out = fn(carry)
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        ts.append(time.time() - t0)
    print(f'{label:12s}: {min(ts)/K*1e3:7.3f} ms/pass', flush=True)


def build(geom):
    ph = _isotropic_photons(N, seed=2)
    state = gpu.GPUPhotons(ph).state
    state = {k: v[:N] for k, v in state.items()}
    n = N
    rng = np.random.RandomState(5)
    res = dict(
        triangle=jnp.asarray(rng.randint(-1, 1000, n), jnp.int32),
        distance=jnp.asarray(rng.uniform(10, 5000, n), jnp.float32),
        normal=jnp.asarray(rng.normal(size=(n, 3)), jnp.float32),
        material_code=jnp.asarray(
            rng.randint(0, 1 << 24, n), jnp.uint32),
        incomplete=jnp.zeros(n, bool),
    )
    active = jnp.asarray(rng.rand(n) < 0.45)
    flags = state['flags']
    nan_mask = jnp.zeros(n, bool)
    return state, res, active, flags, nan_mask


def loop(body, K):
    @jax.jit
    def run(carry):
        return jax.lax.fori_loop(0, K, body, carry)
    return run


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    K = int(sys.argv[2]) if len(sys.argv) > 2 else 200
    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    state, res, active, flags, nan_mask = build(geom)
    key0 = jax.random.PRNGKey(7)

    def full_body(i, carry):
        st, key = carry
        key, sk = jax.random.split(key)
        u = jax.random.uniform(sk, (N, NDRAWS), dtype=jnp.float32)
        st2 = physics_update(st, res, geom, u, flags, active, nan_mask,
                             0)
        return dict(st, pos=st2['pos'], t=st2['t']), key
    timeit('full', loop(full_body, K), (state, key0), K)

    # stub the lookups: constant mid-range values with the right shape
    orig = (P._interp, P._interp_rows, P._sample_icdf_flat)

    def fake_interp(tables, table, idx, wl):
        return jnp.full(wl.shape, 0.5, jnp.float32) + 1e-6 * wl

    def fake_interp_rows(tables, stacked, idx, wl):
        p = stacked.shape[-1]
        return jnp.full(wl.shape + (p,), 0.5, jnp.float32) \
            + 1e-6 * wl[:, None]

    def fake_icdf(icdf, row_idx, u):
        return 400.0 + u
    P._interp = fake_interp
    P._interp_rows = fake_interp_rows
    P._sample_icdf_flat = fake_icdf
    try:
        timeit('-interp', loop(full_body, K), (state, key0), K)
    finally:
        P._interp, P._interp_rows, P._sample_icdf_flat = orig

    # isolated lookup costs at the same width
    nw = int(geom.nwavelengths)
    nmat = geom.refractive_index.shape[0]
    flat = jnp.asarray(
        np.random.RandomState(1).rand(nmat * nw), jnp.float32)
    m1 = jnp.asarray(np.random.RandomState(2).randint(0, nmat, N),
                     jnp.int32)
    wl = state['wavelength']

    def gather_body(i, carry):
        acc, x = carry
        x0, dw = geom.wavelength0, geom.wavelength_step
        xg = jnp.clip((wl + acc * 0) / dw - x0 / dw, 0.0, nw - 1.0)
        jl = jnp.clip(xg.astype(jnp.int32), 0, nw - 2)
        base = m1 * nw + jl
        lo = flat[base]
        hi = flat[base + 1]
        v = lo + (hi - lo) * (xg - jl)
        return acc + v, x
    timeit('gather', loop(gather_body, K),
           (jnp.zeros(N, jnp.float32), 0), K)

    # one-hot matmul lookup of the same table: idx -> one_hot(nmat*nw)
    # @ flat.  Matmul-native; viable only because the table is small.
    tab2d = flat.reshape(nmat * nw, 1)

    def onehot_body(i, carry):
        acc, x = carry
        x0, dw = geom.wavelength0, geom.wavelength_step
        xg = jnp.clip((wl + acc * 0) / dw - x0 / dw, 0.0, nw - 1.0)
        jl = jnp.clip(xg.astype(jnp.int32), 0, nw - 2)
        base = m1 * nw + jl
        oh = jax.nn.one_hot(base, nmat * nw, dtype=jnp.float32)
        lo = (oh @ tab2d)[:, 0]
        oh2 = jax.nn.one_hot(base + 1, nmat * nw, dtype=jnp.float32)
        hi = (oh2 @ tab2d)[:, 0]
        v = lo + (hi - lo) * (xg - jl)
        return acc + v, x
    timeit('onehot', loop(onehot_body, K),
           (jnp.zeros(N, jnp.float32), 0), K)


if __name__ == '__main__':
    main()
