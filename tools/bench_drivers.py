"""A/B the propagation drivers on the real chip.

Usage: python tools/bench_drivers.py [tiny|full] [log2_n] [drivers]
  drivers: string containing 'c' (compacting) / 'f' (fused)
"""
import os
import sys
import time

import numpy as np
import jax

from chroma_jax import gpu
from chroma_jax.benchmark import _isotropic_photons, _sync
from chroma_jax.ops import photon as photon_ops
from chroma_jax.ops.fused import propagate_fused
from chroma_jax.cache import enable_jax_cache

enable_jax_cache()


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    nlog2 = int(sys.argv[2]) if len(sys.argv) > 2 else 18
    drivers = sys.argv[3] if len(sys.argv) > 3 else 'fc'
    n = 1 << nlog2

    gg = gpu.GPUDetector.from_table_cache(which)
    assert gg is not None, 'table cache missing — run tools/build_full_demo.py'
    geom = gg.geom
    print(f'# detector={which} rows={geom.mbvh_rows.shape} n={n}',
          flush=True)

    photons = _isotropic_photons(n)

    if 'f' in drivers:
        for width in (n, n // 2, n // 4):
            gp = gpu.GPUPhotons(photons)
            state = gp.state
            key = jax.random.PRNGKey(1)
            f = lambda: propagate_fused(state, geom, key, max_steps=100,
                                        width=width)[0]['flags']
            t0 = time.time()
            _sync(f())
            print(f'fused width={width}: compile+run {time.time()-t0:.1f}s',
                  flush=True)
            ts = []
            for _ in range(2):
                t0 = time.time()
                _sync(f())
                ts.append(time.time() - t0)
            t = min(ts)
            print(f'fused width={width}: {t:.3f}s = {n/t/1e3:.1f}k photons/s',
                  flush=True)

    if 'c' in drivers:
        gp = gpu.GPUPhotons(photons)
        state0 = gp.state
        key = jax.random.PRNGKey(1)

        def run_c():
            st, _ = photon_ops.propagate_compacting(
                {k: v for k, v in state0.items()}, geom, key,
                max_steps=100)
            return st['flags']

        t0 = time.time()
        _sync(run_c())
        print(f'compacting: compile+run {time.time()-t0:.1f}s', flush=True)
        ts = []
        for _ in range(2):
            t0 = time.time()
            _sync(run_c())
            ts.append(time.time() - t0)
        t = min(ts)
        print(f'compacting: {t:.3f}s = {n/t/1e3:.1f}k photons/s', flush=True)


if __name__ == '__main__':
    main()
