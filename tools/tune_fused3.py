"""Fused-driver sweep: width x service_every."""
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


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    n = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else 20)
    widths = [int(x) for x in
              os.environ.get('TUNE_WIDTHS', '8192,16384,32768').split(',')]
    ses = [int(x) for x in os.environ.get('TUNE_SE', '4,6,10').split(',')]

    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    print(f'# detector={which} n={n}', flush=True)
    gp = gpu.GPUPhotons(_isotropic_photons(n))
    state = gp.state
    key = jax.random.PRNGKey(1)

    for width in widths:
        for se in ses:
            f = lambda: propagate_fused(state, geom, key, max_steps=100,
                                        width=width, service_every=se)
            t0 = time.time()
            out, stats = f()
            _sync(out['flags'])
            tc = time.time() - t0
            ts = []
            for _ in range(2):
                t0 = time.time()
                out, stats = f()
                _sync(out['flags'])
                ts.append(time.time() - t0)
            t = min(ts)
            sv, steps, li, ai = [int(x) for x in np.asarray(stats)]
            print(f'w={width:6d} se={se:2d}: {t:.3f}s {n/t/1e6:5.2f}M ph/s'
                  f' | srv={sv} steps/ph={steps/n:.2f}'
                  f' util={ai/max(li,1):.2f}'
                  f' rows/ph-step={ai/max(steps,1):.1f}'
                  f' (compile {tc:.0f}s)', flush=True)


if __name__ == '__main__':
    main()
