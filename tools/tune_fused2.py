"""Follow-up fused sweep: narrow widths + big pools."""
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


def run(state, geom, key, n, width, se):
    f = lambda: propagate_fused(state, geom, key, max_steps=100,
                                width=width, service_every=se)
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
    print(f'n={n} w={width:7d} se={se:2d}: {t:.3f}s {n/t/1e3:7.1f}k ph/s'
          f' | srv={sv} util={ai/max(li,1):.2f}'
          f' rows/ph-step={ai/max(steps,1):.1f}', flush=True)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    gg = gpu.GPUDetector.from_table_cache(which)
    geom = gg.geom
    key = jax.random.PRNGKey(1)

    for nl in (20, 21):
        n = 1 << nl
        state = gpu.GPUPhotons(_isotropic_photons(n)).state
        run(state, geom, key, n, 8192, 6)


if __name__ == '__main__':
    main()
