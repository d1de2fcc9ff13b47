"""Record the FULL benchmark suite, not just propagation (r5).

The reference tracks five rates (reference chroma/benchmark.py:22-157):
ray intersections/s, photons loaded/s, photons propagated/s, PDF
events/s, PDF-eval events/s.  bench.py reports only propagation (the
driver's single acceptance metric); this tool runs all five on the
demo detector and writes BENCH_SUITE_r{N}.json at the repo root so
render/PDF regressions stay visible round over round.

Usage:
  python tools/bench_suite.py [--round 5] [--detector full|tiny]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as np  # noqa: E402

from chroma_jax.cache import enable_jax_cache  # noqa: E402

enable_jax_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--round', type=int, default=5)
    ap.add_argument('--detector', default='full',
                    choices=['tiny', 'full'])
    ap.add_argument('--nphotons', type=int, default=1 << 20)
    ap.add_argument('--number', type=int, default=3)
    args = ap.parse_args()

    import jax
    from chroma_jax import gpu, demo, benchmark
    from chroma_jax.sim import Simulation

    gg = gpu.GPUDetector.from_table_cache(args.detector)
    if gg is None:
        geo = demo.detector() if args.detector == 'full' else demo.tiny()
        geo.flatten()
        gg = gpu.GPUDetector(geo)
        gg.save_table_cache(args.detector)

    out = {
        'round': args.round,
        'detector': args.detector,
        'backend': jax.default_backend(),
        'nphotons': args.nphotons,
        'config': {
            k: os.environ.get('CHROMA_JAX_' + k.upper())
            for k in ('service_every', 'chains', 'width')},
    }
    t_start = time.time()

    r = benchmark.intersect(gg, number=args.number,
                            nphotons=args.nphotons)
    out['ray_intersections_per_s'] = float(np.mean(r[1:]))
    print('ray:', out['ray_intersections_per_s'], flush=True)

    r = benchmark.load_photons(number=args.number,
                               nphotons=args.nphotons)
    out['photons_loaded_per_s'] = float(np.mean(r[1:]))
    print('load:', out['photons_loaded_per_s'], flush=True)

    r = benchmark.propagate(gg, number=args.number,
                            nphotons=args.nphotons, max_steps=100)
    out['photons_propagated_per_s'] = float(np.mean(r[1:]))
    print('propagate:', out['photons_propagated_per_s'], flush=True)

    # pdf / pdf_eval ride a Simulation (DAQ needs channel tables);
    # reuse the packed detector rather than re-flattening by hand-
    # assembling the device-state fields Simulation.__init__ builds
    class _DetShim:
        """Just enough of the host Detector for the PDF paths: the
        packed tables already carry the channel count."""
        def __init__(self, nchannels):
            self._n = nchannels

        def num_channels(self):
            return self._n

    sim_obj = Simulation.__new__(Simulation)
    sim_obj.detector = _DetShim(int(gg.nchannels))
    sim_obj.photon_tracking = False
    sim_obj.seed = 1
    np.random.seed(1)
    sim_obj.photon_generator = None
    sim_obj.gpu_geometry = gg
    sim_obj.gpu_daq = gpu.GPUDaq(gg)
    sim_obj.gpu_pdf = gpu.GPUPDF()
    sim_obj.gpu_pdf_kernel = gpu.GPUKernelPDF()
    sim_obj.mesh = None
    sim_obj.rng_states = gpu.get_rng_states(seed=1)
    sim_obj.pdf_config = None

    r = benchmark.pdf(sim_obj, number=max(args.number, 2))
    out['pdf_events_per_s'] = float(np.mean(r[1:]))
    print('pdf:', out['pdf_events_per_s'], flush=True)

    r = benchmark.pdf_eval(sim_obj, number=max(args.number, 2))
    out['pdf_eval_events_per_s'] = float(np.mean(r[1:]))
    print('pdf_eval:', out['pdf_eval_events_per_s'], flush=True)

    out['wall_s'] = time.time() - t_start
    path = os.path.join(os.path.dirname(__file__), '..',
                        'BENCH_SUITE_r%02d.json' % args.round)
    with open(path, 'w') as f:
        json.dump(out, f, indent=2)
        f.write('\n')
    print('wrote', os.path.abspath(path))


if __name__ == '__main__':
    main()
