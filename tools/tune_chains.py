"""Sweep the software-pipelined chain count of the fused driver.

Chains overlap one batch's row gathers with another's arithmetic
(ops/fused.py module docstring).  Usage:
  PYTHONPATH=. python tools/tune_chains.py [tiny|full] [log2_n]
"""
import os
import sys
import time

import numpy as np
import jax

from chroma_jax import gpu
from chroma_jax.benchmark import _isotropic_photons, _sync
from chroma_jax.ops.fused import propagate_fused
from chroma_jax.cache import enable_jax_cache

enable_jax_cache()


def run(state, geom, key, n, width, se, chains):
    f = lambda: propagate_fused(state, geom, key, max_steps=100,
                                width=width, service_every=se,
                                chains=chains)
    out, stats = f()
    _sync(out['flags'])
    ts = []
    for _ in range(2):
        t0 = time.time()
        out, stats = f()
        _sync(out['flags'])
        ts.append(time.time() - t0)
    t = min(ts)
    sv, steps, li, ai = [int(x) for x in np.asarray(stats)]
    print(f'n={n} w={width:6d} se={se:2d} C={chains}: {t:.3f}s '
          f'{n/t/1e3:7.1f}k ph/s | util={ai/max(li,1):.2f} '
          f'rows/ph-step={ai/max(steps,1):.1f}', flush=True)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    nlog2 = int(sys.argv[2]) if len(sys.argv) > 2 else 20
    n = 1 << nlog2
    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    key = jax.random.PRNGKey(1)
    state = gpu.GPUPhotons(_isotropic_photons(n)).state

    import sys as _s
    # each extra argv is one config 'chains:width:se'
    cfgs = [tuple(int(v) for v in a.split(':')) for a in _s.argv[3:]] \
        or [(1, 8192, 6), (2, 8192, 6), (2, 16384, 6), (3, 12288, 6),
            (4, 16384, 6), (2, 16384, 8), (4, 32768, 8)]
    for chains, width, se in cfgs:
        print(f'# compiling C={chains} w={width} se={se}', flush=True)
        run(state, geom, key, n, width, se, chains)


if __name__ == '__main__':
    main()
