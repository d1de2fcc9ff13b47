"""Benchmark suite (parity: chroma/benchmark.py — same rates on the
demo detector: ray intersections/s, photons loaded/s, photons
propagated/s, PDF events/s, PDF-eval events/s)."""
import argparse
import time

import numpy as np
import jax

from chroma_jax import gpu, demo
from chroma_jax import event
from chroma_jax.event import Photons
from chroma_jax.sample import uniform_sphere
from chroma_jax.tools import argsort_direction
from chroma_jax.ops import mbvh as mbvh_ops
from chroma_jax.ops import photon as photon_ops
from chroma_jax.generator.photon import photon_bomb


def _sync(x):
    jax.block_until_ready(x)


def nvidia_smi_line():
    """The card's name and power limit as nvidia-smi reports them
    ("NVIDIA H100 80GB HBM3, 700.00 W"), or a note why it could not be
    read.  A card set below its maximum power runs slower under load,
    so every reported time carries this line."""
    import subprocess
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return 'nvidia-smi unavailable (%s)' % e
    return out.stdout.strip() or 'nvidia-smi failed: ' + out.stderr.strip()


def require_gpu():
    """The device record {platform, kind, count} of this process's
    accelerator; raises SystemExit when JAX found no GPU, because a
    time taken on the CPU backend is not a device measurement."""
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        raise SystemExit('no GPU: JAX found only %r devices (%s)'
                         % (dev.platform, dev.device_kind))
    return {'platform': dev.platform, 'kind': dev.device_kind,
            'count': len(jax.devices())}


def _center_rays(nphotons, seed=0, sort=True):
    rng = np.random.RandomState(seed)
    dirs = rng.normal(size=(nphotons, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    if sort:
        dirs = dirs[argsort_direction(dirs)]
    pos = np.zeros((nphotons, 3), dtype=np.float32)
    return pos, dirs


def _isotropic_photons(nphotons, seed=0, wavelength=400.0):
    pos, dirs = _center_rays(nphotons, seed)
    pol = np.cross(uniform_sphere(nphotons), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    return Photons(pos=pos, dir=dirs, pol=pol,
                   wavelengths=np.full(nphotons, wavelength, np.float32))


def intersect(gpu_geometry, number=10, nphotons=500000, nthreads_per_block=None,
              max_blocks=None):
    """Ray intersections/s (reference: chroma/benchmark.py:22)."""
    import jax.numpy as jnp
    pos, dirs = _center_rays(nphotons)
    o, d = jnp.asarray(pos), jnp.asarray(dirs)
    res = mbvh_ops.intersect_mesh(o, d, gpu_geometry.geom)
    _sync(res['triangle'])
    run_times = []
    for _ in range(number):
        t0 = time.time()
        res = mbvh_ops.intersect_mesh(o, d, gpu_geometry.geom)
        _sync(res['triangle'])
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times)


def load_photons(number=10, nphotons=500000):
    """Photon upload rate (reference: chroma/benchmark.py:48)."""
    photons = _isotropic_photons(nphotons)
    run_times = []
    for _ in range(number):
        t0 = time.time()
        gp = gpu.GPUPhotons(photons)
        _sync(gp.state['pos'])
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times)


def propagate(gpu_geometry, number=10, nphotons=500000, max_steps=100):
    """Full-physics propagation rate (reference: chroma/benchmark.py:70)."""
    rng_states = gpu.get_rng_states(seed=1)
    photons = _isotropic_photons(nphotons)
    gp = gpu.GPUPhotons(photons)
    gp.propagate(gpu_geometry, rng_states, max_steps=max_steps)
    _sync(gp.state['flags'])
    run_times = []
    for _ in range(number):
        gp = gpu.GPUPhotons(photons)
        # finish the async upload before the clock starts: the
        # reference's pycuda H2D completes before its t0 too
        # (reference chroma/benchmark.py:84-87), and upload rate is
        # its own metric (load_photons)
        _sync(gp.state['pos'])
        t0 = time.time()
        gp.propagate(gpu_geometry, rng_states, max_steps=max_steps)
        _sync(gp.state['flags'])
        run_times.append(time.time() - t0)
    return nphotons / np.array(run_times)


def pdf(sim_obj, number=10, nphotons=100000, nbins=128):
    """PDF-filling events/s (reference: chroma/benchmark.py:99), using
    photon bombs in place of Geant4 events."""
    run_times = []
    for _ in range(number):
        ev = photon_bomb(nphotons, 400.0, (0, 0, 0))
        t0 = time.time()
        sim_obj.create_pdf([ev.photons_beg], nbins, (-0.5, 999.5), 10,
                           (-0.5, 9.5))
        run_times.append(time.time() - t0)
    return 1.0 / np.array(run_times)


def pdf_eval(sim_obj, number=3, nphotons=20000, nreps=2, ndaq=32):
    """PDF-eval events/s (reference: chroma/benchmark.py:157)."""
    ev0 = next(sim_obj.simulate(
        photon_bomb(nphotons, 400.0, (0, 0, 0)).photons_beg, run_daq=True))
    run_times = []
    for _ in range(number):
        photons = photon_bomb(nphotons, 400.0, (0, 0, 0)).photons_beg
        t0 = time.time()
        sim_obj.eval_pdf(ev0.channels, photons, 0.2, (-0.5, 999.5), 1,
                         (-0.5, 9.5), nreps=nreps, ndaq=ndaq,
                         min_bin_content=20)
        run_times.append(time.time() - t0)
    return 1.0 / np.array(run_times)


def _report(name, rates, unit):
    print('%s: %.3g +/- %.2g %s' % (name, rates[1:].mean(),
                                    rates[1:].std(), unit))
    return float(rates[1:].mean())


def main():
    parser = argparse.ArgumentParser(description='chroma_jax benchmarks')
    parser.add_argument('--detector', default='tiny',
                        choices=['tiny', 'full'])
    parser.add_argument('--nphotons', type=int, default=500000)
    parser.add_argument('--number', type=int, default=4)
    parser.add_argument('--benchmarks', default='ray,load,propagate',
                        help='comma list: ray,load,propagate,pdf,pdf_eval')
    args = parser.parse_args()
    device = require_gpu()
    print('%s x%d; %s' % (device['kind'], device['count'],
                          nvidia_smi_line()))

    from chroma_jax.sim import Simulation
    geo_obj = demo.tiny if args.detector == 'tiny' else demo.detector
    sim_obj = Simulation(geo_obj(), geant4_processes=0, seed=1)

    results = {}
    wanted = args.benchmarks.split(',')
    if 'ray' in wanted:
        results['ray_intersections_per_s'] = _report(
            'ray intersections', intersect(sim_obj.gpu_geometry,
                                           args.number, args.nphotons),
            'rays/s')
    if 'load' in wanted:
        results['photons_loaded_per_s'] = _report(
            'photons loaded', load_photons(args.number, args.nphotons),
            'photons/s')
    if 'propagate' in wanted:
        results['photons_propagated_per_s'] = _report(
            'photons propagated', propagate(sim_obj.gpu_geometry,
                                            args.number, args.nphotons),
            'photons/s')
    if 'pdf' in wanted:
        results['pdf_events_per_s'] = _report(
            'pdf events', pdf(sim_obj, max(args.number, 2)), 'events/s')
    if 'pdf_eval' in wanted:
        results['pdf_eval_events_per_s'] = _report(
            'pdf eval events', pdf_eval(sim_obj), 'events/s')
    return results


if __name__ == '__main__':
    main()
