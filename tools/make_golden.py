"""Generate the golden hit-PDF snapshot for tests/test_golden.py.

Provenance: produced by THIS framework (seed below) on the demo.tiny
detector and validated against the analytic expectations asserted in
tests/test_propagation.py (time-of-flight peak, Fresnel rates,
Rayleigh angular law) — the CUDA reference is not runnable on this
machine (no NVIDIA GPU), so the golden file guards statistical
regressions and provides the harness into which reference-generated
histograms can be dropped: produce the same file from reference
chroma with `python tools/make_golden.py --out <path>` semantics
(bomb position/count/wavelength below) and the same test validates
cross-package agreement.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), '..'))
from golden_config import (GOLDEN_SEED, NPHOTONS, WAVELENGTH,  # noqa: E402
                           BOMB_POS, NEVENTS, TIME_BINS, CHARGE_BINS,
                           FULL_SEED, FULL_NPHOTONS, FULL_NEVENTS,
                           FULL_TIME_BINS)


def simulate_histograms(seed):
    from chroma_jax import demo
    from chroma_jax.sim import Simulation
    from chroma_jax.generator.photon import photon_bomb

    sim = Simulation(demo.tiny(), geant4_processes=0, seed=seed)
    t_hist = np.zeros(len(TIME_BINS) - 1)
    q_hist = np.zeros(len(CHARGE_BINS) - 1)
    nhit = 0
    det_frac = []
    for i in range(NEVENTS):
        ev = next(sim.simulate(
            [photon_bomb(NPHOTONS, WAVELENGTH, BOMB_POS)],
            run_daq=True))
        chan = ev.channels
        hit = np.asarray(chan.hit, bool)
        t_hist += np.histogram(np.asarray(chan.t)[hit], TIME_BINS)[0]
        q_hist += np.histogram(np.asarray(chan.q)[hit], CHARGE_BINS)[0]
        nhit += int(hit.sum())
        det_frac.append(len(ev.flat_hits) / float(NPHOTONS))
    return dict(t_hist=t_hist, q_hist=q_hist, nhit=np.asarray(nhit),
                det_frac=np.asarray(np.mean(det_frac)),
                time_bins=TIME_BINS, charge_bins=CHARGE_BINS,
                nevents=np.asarray(NEVENTS),
                nphotons=np.asarray(NPHOTONS),
                wavelength=np.asarray(WAVELENGTH),
                bomb_pos=np.asarray(BOMB_POS),
                seed=np.asarray(GOLDEN_SEED),
                engine=np.asarray('chroma_jax'))


# ---- full-demo golden (VERDICT r2 #9): hit-time PDF + detection
# fraction on the 10,055-PMT benchmark geometry, so traversal/driver
# perf work cannot silently change the physics.  Requires the 'full'
# packed-table cache (tools/build_full_demo.py); the matching test
# (tests/test_golden.py::test_golden_full_demo) skips without it.
def simulate_full_histograms(seed, nevents=FULL_NEVENTS):
    import jax
    from chroma_jax import event, gpu

    gg = gpu.GPUDetector.from_table_cache('full')
    if gg is None:
        return None
    t_hist = np.zeros(len(FULL_TIME_BINS) - 1)
    det = 0
    for i in range(nevents):
        ph = _full_bomb(FULL_NPHOTONS, seed * 1000 + i)
        p = gpu.GPUPhotons(ph)
        p.propagate(gg, gpu.get_rng_states(seed=seed * 77 + i))
        flags = np.asarray(p.state['flags'])
        detected = (flags & event.SURFACE_DETECT) != 0
        det += int(detected.sum())
        t_hist += np.histogram(np.asarray(p.state['t'])[detected],
                               FULL_TIME_BINS)[0]
    return dict(t_hist=t_hist,
                det_frac=np.asarray(det / float(nevents * FULL_NPHOTONS)),
                time_bins=FULL_TIME_BINS, nevents=np.asarray(nevents),
                nphotons=np.asarray(FULL_NPHOTONS),
                seed=np.asarray(seed),
                engine=np.asarray('chroma_jax'))


def _full_bomb(n, seed):
    from chroma_jax.generator.photon import photon_bomb
    np.random.seed(seed)
    return photon_bomb(n, WAVELENGTH, (0.0, 0.0, 0.0)).photons_beg


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'tests', 'golden', 'demo_tiny_pdf.npz'))
    parser.add_argument('--full', action='store_true',
                        help='write the full-demo golden instead')
    args = parser.parse_args()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    if args.full:
        out = args.out
        if out.endswith('demo_tiny_pdf.npz'):
            out = out.replace('demo_tiny_pdf.npz', 'demo_full_pdf.npz')
        data = simulate_full_histograms(FULL_SEED)
        if data is None:
            raise SystemExit("no 'full' table cache; run "
                             "tools/build_full_demo.py first")
        np.savez_compressed(out, **data)
        print('wrote', out, 'det_frac=%.5f' % float(data['det_frac']))
        return
    data = simulate_histograms(GOLDEN_SEED)
    np.savez_compressed(args.out, **data)
    print('wrote', args.out, 'nhit=', int(data['nhit']),
          'det_frac=%.4f' % float(data['det_frac']))


if __name__ == '__main__':
    main()
