"""Generate golden hit-PDF snapshots from the CUDA REFERENCE engine.

Run this ON A CUDA HOST with reference chroma installed
(github.com/pennneutrinos/chroma + pycuda + an NVIDIA GPU):

    python tools/make_golden_reference.py --out tests/golden/

It simulates the SAME configurations as tools/make_golden.py — both
import every number and the scene builders from tools/golden_config.py,
so config parity between the engines holds by construction — and
writes npz files in the same schema, labeled engine='chroma-cuda'.
Drop the outputs into tests/golden/ and the existing tests
(tests/test_golden.py) validate cross-package agreement with the same
chi^2 machinery; until then the goldens there are self-generated
regression pins (provenance in each file's ``engine`` field).

Configurations (reference shape: chroma/test/test_detector.py:26-77):

  * demo-tiny bomb     — hit-time/charge histograms, detection frac
  * analytic sphere    — the closed-form fixture of
                         tests/test_golden_analytic.py; the reference
                         must land inside the SAME analytic windows

This file intentionally imports ``chroma`` (the reference), not
``chroma_jax`` — it will refuse to run where the reference is absent.
"""
import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(__file__))
import golden_config as cfg


def _require_reference():
    try:
        import chroma  # noqa: F401
        import chroma.demo
        import chroma.sim
    except ImportError as e:
        raise SystemExit(
            'reference chroma is not importable here (%s).  This tool '
            'runs on a CUDA host with pennneutrinos/chroma installed; '
            'on this machine use tools/make_golden.py (chroma_jax '
            'engine) instead.' % e)


def simulate_tiny(seed):
    from chroma import demo
    from chroma.sim import Simulation
    from chroma.generator.photon import photon_bomb

    sim = Simulation(demo.tiny(), geant4_processes=0, seed=seed)
    t_hist = np.zeros(len(cfg.TIME_BINS) - 1)
    q_hist = np.zeros(len(cfg.CHARGE_BINS) - 1)
    nhit = 0
    det_frac = []
    for i in range(cfg.NEVENTS):
        ev = next(sim.simulate(
            [photon_bomb(cfg.NPHOTONS, cfg.WAVELENGTH, cfg.BOMB_POS)],
            run_daq=True))
        chan = ev.channels
        hit = np.asarray(chan.hit, bool)
        t_hist += np.histogram(np.asarray(chan.t)[hit],
                               cfg.TIME_BINS)[0]
        q_hist += np.histogram(np.asarray(chan.q)[hit],
                               cfg.CHARGE_BINS)[0]
        nhit += int(hit.sum())
        det_frac.append(len(ev.flat_hits) / float(cfg.NPHOTONS))
    return dict(t_hist=t_hist, q_hist=q_hist, nhit=np.asarray(nhit),
                det_frac=np.asarray(np.mean(det_frac)),
                time_bins=cfg.TIME_BINS, charge_bins=cfg.CHARGE_BINS,
                nevents=np.asarray(cfg.NEVENTS),
                nphotons=np.asarray(cfg.NPHOTONS),
                wavelength=np.asarray(cfg.WAVELENGTH),
                bomb_pos=np.asarray(cfg.BOMB_POS),
                seed=np.asarray(seed),
                engine=np.asarray('chroma-cuda'))


def simulate_sphere(seed):
    from chroma import make
    from chroma.geometry import Solid, Material, Surface
    from chroma.detector import Detector
    from chroma.sim import Simulation
    from chroma.generator.photon import photon_bomb

    det = cfg.build_analytic_sphere(make, Solid, Material, Surface,
                                    Detector)
    sim = Simulation(det, geant4_processes=0, seed=seed)
    ch_t, ch_q, det_frac = [], [], []
    for i in range(cfg.SPHERE_NEVENTS):
        ev = next(sim.simulate(
            [photon_bomb(cfg.SPHERE_NPHOTONS, cfg.SPHERE_WAVELENGTH,
                         (0.0, 0.0, 0.0))],
            run_daq=True, keep_photons_end=True))
        det_frac.append(len(ev.flat_hits) / float(cfg.SPHERE_NPHOTONS))
        ch_t.append(float(np.asarray(ev.channels.t)[0]))
        ch_q.append(float(np.asarray(ev.channels.q)[0]))
    return dict(det_frac=np.asarray(det_frac),
                channel_t=np.asarray(ch_t), channel_q=np.asarray(ch_q),
                nevents=np.asarray(cfg.SPHERE_NEVENTS),
                nphotons=np.asarray(cfg.SPHERE_NPHOTONS),
                seed=np.asarray(seed),
                engine=np.asarray('chroma-cuda'))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        'tests', 'golden'))
    args = parser.parse_args()
    _require_reference()
    os.makedirs(args.out, exist_ok=True)

    data = simulate_tiny(cfg.GOLDEN_SEED)
    path = os.path.join(args.out, 'demo_tiny_pdf_reference.npz')
    np.savez_compressed(path, **data)
    print('wrote', path, 'nhit=', int(data['nhit']),
          'det_frac=%.4f' % float(data['det_frac']))

    data = simulate_sphere(cfg.SPHERE_SEED)
    path = os.path.join(args.out, 'analytic_sphere_reference.npz')
    np.savez_compressed(path, **data)
    print('wrote', path,
          'det_frac=%.4f' % float(np.mean(data['det_frac'])))


if __name__ == '__main__':
    main()
