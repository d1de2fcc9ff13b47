"""Sweep fused-driver knobs (width, service_every) on the real chip.

Usage: python tools/tune_fused.py [tiny|full] [log2_n]
Reports time, photons/s, and the utilization stats:
  services, photon_steps, lane_iters (gathers paid),
  active_iters (gathers useful).
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


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    nlog2 = int(sys.argv[2]) if len(sys.argv) > 2 else 18
    n = 1 << nlog2

    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    print(f'# detector={which} rows={geom.mbvh_rows.shape} n={n}',
          flush=True)
    photons = _isotropic_photons(n)
    gp = gpu.GPUPhotons(photons)
    state = gp.state
    key = jax.random.PRNGKey(1)

    for width in (n // 16, n // 8, n // 4):
        for se in (4, 6, 10):
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
            print(f'w={width:7d} se={se:2d}: {t:.3f}s '
                  f'{n/t/1e3:7.1f}k ph/s | srv={sv:5d} '
                  f'ph-steps={steps} steps/ph={steps/n:.2f} '
                  f'gathers={li} useful={ai} '
                  f'util={ai/max(li,1):.2f} rows/ph-step='
                  f'{ai/max(steps,1):.1f} (compile {tc:.0f}s)',
                  flush=True)


if __name__ == '__main__':
    main()
