"""Driver benchmark: photons/s propagated through the demo detector on
one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N,
   "device": {"platform": "gpu", "kind": ..., "count": N},
   "gpu": "<nvidia-smi name, power limit>"}

Baseline: 2.5M photons/s, full physics, on the reference's demo-class
detector on one GPU (reference README.md:5).  Our full demo carries
10,055 PMTs / 42M triangles (tools/build_full_demo.py).

The measurement runs in child processes, one after another, so this
parent never imports JAX and at most one process holds the card.  The
child tries the full demo detector first and falls back to the tiny
demo, labeling the metric with the detector actually used.  The
bit-integrity referee (chroma_jax/referee.py) runs before the rate is
taken, and a failure refuses the rate.  Without a GPU the run fails:
no rate comes from the CPU backend.
"""
import json
import os
import subprocess
import sys

BASELINE_PHOTONS_PER_S = 2.5e6

_CHILD_CODE = r"""
import os, json
import numpy as np
from chroma_jax import gpu, demo
from chroma_jax.benchmark import propagate, require_gpu, nvidia_smi_line
from chroma_jax.cache import enable_jax_cache
from chroma_jax.referee import run_referee

try:
    device = require_gpu()
except SystemExit as e:
    print('RESULT ' + json.dumps({'error': str(e)}), flush=True)
    raise
enable_jax_cache()

which = os.environ.get('BENCH_DETECTOR', 'full')
gg = gpu.GPUDetector.from_table_cache(which)
if gg is None:
    # cold build: the instanced TLAS/BLAS pack needs only the
    # flattened scene (no legacy BVH)
    geo = demo.detector() if which == 'full' else demo.tiny()
    geo.flatten()
    gg = gpu.GPUDetector(geo)
    gg.save_table_cache(which)

# a rate from an engine that corrupts photon state is worthless
failures = run_referee(gg.geom)
if failures:
    print('RESULT ' + json.dumps(
        {'error': 'bit-integrity referee failed',
         'referee_failures': failures}))
    raise SystemExit(1)

nphotons = int(os.environ.get('BENCH_NPHOTONS', 1 << 20))
# number=5, discard the first rep: same discard-first protocol as the
# reference benchmark (reference chroma/benchmark.py:70 uses number=10)
rates = propagate(gg, number=int(os.environ.get('BENCH_NUMBER', 5)),
                  nphotons=nphotons, max_steps=100)
print('RESULT ' + json.dumps({'value': float(np.mean(rates[1:])),
                              'device': device,
                              'gpu': nvidia_smi_line()}))
"""


def _try(detector, nphotons, timeout):
    """Run the child on one detector; returns its result dict, or None
    when it did not finish.  Exits non-zero on a missing GPU or a
    referee failure, which no other detector can cure."""
    env = dict(os.environ, BENCH_DETECTOR=detector,
               BENCH_NPHOTONS=str(nphotons))
    try:
        out = subprocess.run([sys.executable, '-c', _CHILD_CODE], env=env,
                             capture_output=True, text=True,
                             timeout=timeout)
    except subprocess.TimeoutExpired:
        return None
    for line in out.stdout.splitlines():
        if line.startswith('RESULT '):
            res = json.loads(line[len('RESULT '):])
            if 'error' in res:
                print(json.dumps(dict(
                    res, metric='photons propagated/sec (REFUSED: %s)'
                    % res['error'], value=0.0, unit='photons/s',
                    vs_baseline=0.0)))
                sys.exit(1)
            return res
    sys.stderr.write(out.stdout[-2000:] + out.stderr[-2000:])
    return None


def main():
    attempts = [('full', 1 << 20, 3000, 'full demo'
                 ' (10,055 PMTs, 42M triangles)'),
                ('tiny', 1 << 20, 2400, 'tiny demo (300k triangles)')]
    if os.environ.get('BENCH_SKIP_FULL'):
        attempts = attempts[1:]
    for detector, nphotons, timeout, label in attempts:
        res = _try(detector, nphotons, timeout)
        if res is not None:
            print(json.dumps({
                'metric': 'photons propagated/sec, full physics, %s'
                          % label,
                'value': res['value'],
                'unit': 'photons/s',
                'vs_baseline': res['value'] / BASELINE_PHOTONS_PER_S,
                'device': res['device'],
                'gpu': res['gpu'],
            }))
            return
    print(json.dumps({
        'metric': 'photons propagated/sec (benchmark failed to run)',
        'value': 0.0, 'unit': 'photons/s', 'vs_baseline': 0.0}))
    sys.exit(1)


if __name__ == '__main__':
    main()
