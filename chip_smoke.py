"""Smoke test of the propagation engine on the GPU.

Run from the repository root on a host with one GPU:

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --multi    # four cards: the sharded path only

One card:
  1. device   — refuse anything but a GPU; print the card, its power
                limit, the JAX version and the compile cache in use.
  2. referee  — the bit-integrity terminal passthrough at
                referee.WIDTHS, bit for bit.
  3. full     — Simulation(demo.detector()).simulate(..., run_daq=True)
                on 2^20 400 nm photons through the full demo detector
                (10,055 PMTs, 42M triangles): setup, first-call and warm
                times, driver stats, peak device memory; every photon
                terminal, photons detected, DAQ consistent with them.
  4. compare  — the card against the plain reference: intersect_mesh
                on the CPU device, the fused driver against the
                compacting driver, the DAQ on the CPU device.
  5. pdf      — one create_pdf and one eval_pdf on the tiny demo.

--multi (four cards): the dryrun_multichip(4) fixture with its
closed-form windows, and full-demo propagate+DAQ of 4 x 2^20 photons on
a 1-D four-card mesh against one card on the same photons.

Every phase raises on failure, so the script exits non-zero unless all
passed.  The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# photon-flag fractions compared between the fused and compacting drivers
FLAG_NAMES = ('NO_HIT', 'BULK_ABSORB', 'SURFACE_DETECT', 'SURFACE_ABSORB',
              'BULK_REEMIT')


class SmokeFailure(Exception):
    """A phase's check did not hold."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(phase, msg):
    print('[%s] %s' % (phase, msg), flush=True)


# ---- comparators (pure numpy; tests/test_chip_smoke.py covers them) ----

def compare_hits(tri, dist, tri_ref, dist_ref, min_agree=0.9999,
                 rtol=1e-5):
    """Card vs reference closest hits.  XLA:GPU contracts multiply-adds
    into FMAs, so near-tie slab and triangle tests may round the other
    way: require identical triangle ids for ``min_agree`` of the rays
    and distances within ``rtol`` where the ids agree.  Returns
    (ok, n_mismatch, max_rel_err)."""
    tri, tri_ref = np.asarray(tri), np.asarray(tri_ref)
    dist, dist_ref = np.asarray(dist), np.asarray(dist_ref)
    same = tri == tri_ref
    n_mismatch = int((~same).sum())
    hit = same & (tri >= 0)
    rel = np.abs(dist[hit] - dist_ref[hit]) \
        / np.maximum(np.abs(dist_ref[hit]), 1e-30)
    max_rel = float(rel.max()) if rel.size else 0.0
    ok = (same.mean() >= min_agree) and max_rel <= rtol
    return bool(ok), n_mismatch, max_rel


def compare_fractions(flags_a, flags_b, bits, nsigma=5.0):
    """Two samples of photon flags drawn from the same physics: for each
    named bit the fraction of photons carrying it must agree within
    ``nsigma`` binomial standard errors.  Returns (ok, rows) with one
    (name, frac_a, frac_b, pull) row per bit."""
    flags_a, flags_b = np.asarray(flags_a), np.asarray(flags_b)
    na, nb = len(flags_a), len(flags_b)
    ok, rows = True, []
    for name, bit in bits:
        ka = int(((flags_a & bit) != 0).sum())
        kb = int(((flags_b & bit) != 0).sum())
        p = (ka + kb) / (na + nb)
        sigma = np.sqrt(p * (1 - p) * (1.0 / na + 1.0 / nb))
        diff = ka / na - kb / nb
        pull = 0.0 if diff == 0 else \
            (np.inf if sigma == 0 else abs(diff) / sigma)
        rows.append((name, ka / na, kb / nb, float(pull)))
        ok = ok and pull <= nsigma
    return bool(ok), rows


def compare_daq(hit, q, hit_ref, q_ref, rtol=1e-5):
    """Card vs reference DAQ on the same photons and key: hit channels
    identical; total charge within ``rtol`` (the card sums charges with
    atomics, in an order that varies from run to run).  Returns
    (ok, n_channel_mismatch, rel_err_total_charge)."""
    hit, hit_ref = np.asarray(hit, bool), np.asarray(hit_ref, bool)
    qt, qt_ref = float(np.sum(q)), float(np.sum(q_ref))
    n_mis = int((hit != hit_ref).sum())
    rel = abs(qt - qt_ref) / max(abs(qt_ref), 1e-30)
    return bool(n_mis == 0 and rel <= rtol), n_mis, rel


def within_sigma(a, b, sigma, nsigma=5.0):
    """|a - b| within ``nsigma`` standard deviations of the difference."""
    return abs(a - b) <= nsigma * sigma


# ---- phases --------------------------------------------------------------

def phase_device():
    import jax
    from chroma_jax.benchmark import require_gpu, nvidia_smi_line
    from chroma_jax.cache import enable_jax_cache
    device = require_gpu()
    log('device', '%s x%d (platform %s)' % (device['kind'], device['count'],
                                            device['platform']))
    log('device', 'nvidia-smi: %s' % nvidia_smi_line())
    log('device', 'jax %s, compile cache %s'
        % (jax.__version__, enable_jax_cache()))
    return device


def phase_referee(geom, widths=None):
    from chroma_jax import referee
    t0 = time.time()
    failures = referee.run_referee(geom, widths or referee.WIDTHS)
    check(not failures, 'referee: %s' % '; '.join(failures))
    log('referee', 'terminal passthrough bit-exact at widths %s (%.1f s)'
        % (tuple(widths or referee.WIDTHS), time.time() - t0))


def _bomb(n, seed):
    from chroma_jax.generator.photon import photon_bomb
    np.random.seed(seed)
    return photon_bomb(n, 400.0, (0, 0, 0)).photons_beg


def phase_full(make_detector, nphotons=1 << 20, seed=1):
    """Main path at full size; returns (sim, propagated GPUPhotons)."""
    import jax
    from chroma_jax import event, gpu
    from chroma_jax.sim import Simulation

    t0 = time.time()
    sim = Simulation(make_detector(), geant4_processes=0, seed=seed)
    geom = sim.gpu_geometry.geom
    log('full', 'setup (build + flatten + pack): %.1f s; %d triangles, '
        '%d channels, %d MBVH rows, instanced=%s'
        % (time.time() - t0, len(sim.detector.mesh.triangles),
           sim.gpu_geometry.nchannels, geom.mbvh_rows.shape[0],
           geom.mbvh_instanced))
    photons = _bomb(nphotons, seed)

    def simulate():
        t = time.time()
        ev = next(sim.simulate(photons, keep_photons_end=True,
                               run_daq=True))
        return ev, time.time() - t

    ev, t_first = simulate()
    log('full', 'first call (compile + run): %.1f s' % t_first)
    ev, t_warm = simulate()
    log('full', 'warm simulate (upload + propagate + DAQ + download): '
        '%.3f s, %.0f photons/s' % (t_warm, nphotons / t_warm))

    gp = gpu.GPUPhotons(photons)
    jax.block_until_ready(gp.state['pos'])
    t = time.time()
    gp.propagate(sim.gpu_geometry, sim.rng_states)
    jax.block_until_ready(gp.state['flags'])
    t_prop = time.time() - t
    services, steps, lane_iters, active_iters = (int(x) for x in
                                                 gp.last_stats)
    log('full', 'warm propagate: %.3f s, %.0f photons/s'
        % (t_prop, nphotons / t_prop))
    log('full', 'stats: %d service passes, %d photon steps, %d lane '
        'iterations, %d active lane iterations'
        % (services, steps, lane_iters, active_iters))
    log('full', 'walker: %.3f ns per lane-iteration (warm propagate time '
        '/ lane iterations), lane utilization %.3f'
        % (t_prop * 1e9 / max(lane_iters, 1),
           active_iters / max(lane_iters, 1)))
    stats = jax.devices()[0].memory_stats() or {}
    log('full', 'peak device memory: %.2f GB'
        % (stats.get('peak_bytes_in_use', 0) / 1e9))

    end = ev.photons_end
    flags = end.flags
    check(len(flags) == nphotons, 'photons_end has %d photons, not %d'
          % (len(flags), nphotons))
    # a photon still bouncing after max_steps (100) steps is returned
    # in flight, as by the reference; it must have moved and carry
    # history bits, and such photons must be rare
    open_ = (flags & event.TERMINAL_FLAGS) == 0
    n_open = int(open_.sum())
    moved = np.any(end.pos[open_] != photons.pos[open_], axis=1)
    check(n_open <= nphotons * 1e-4 and moved.all()
          and (flags[open_] != 0).all(),
          '%d photons not terminal (%d of them never moved)'
          % (n_open, int((~moved).sum())))
    detected = (flags & event.SURFACE_DETECT) != 0
    n_det = int(detected.sum())
    check(n_det > 0, 'no photon detected')
    hit_ch = np.flatnonzero(ev.channels.hit)
    hit_from_photons = np.unique(ev.flat_hits.channel)
    check(np.array_equal(hit_ch, hit_from_photons),
          'DAQ hit %d channels, detected photons reach %d'
          % (len(hit_ch), len(hit_from_photons)))
    check(len(ev.flat_hits) == n_det, '%d flat hits for %d detected '
          'photons' % (len(ev.flat_hits), n_det))
    icdf = np.asarray(sim.gpu_geometry.det.charge_icdf)
    q_mean, q_rms = float(icdf.mean()), float(icdf.std())
    q_total = float(ev.channels.q.sum())
    sigma = q_rms * np.sqrt(n_det) \
        + n_det * float(sim.gpu_geometry.det.charge_unit)
    check(within_sigma(q_total, n_det * q_mean, sigma),
          'total charge %.1f vs %d detected x %.3f' % (q_total, n_det,
                                                      q_mean))
    log('full', '%d photons terminal, %d still in flight after max_steps, '
        '%d detected on %d channels, total charge %.1f (expected %.1f)'
        % (nphotons - n_open, n_open, n_det, len(hit_ch), q_total,
           n_det * q_mean))
    return sim, gp


def _on_cpu(tree):
    import jax
    return jax.device_put(tree, jax.devices('cpu')[0])


def compare_intersect(label, geom, nrays, seed=0):
    import jax
    import jax.numpy as jnp
    from chroma_jax.ops.mbvh import intersect_mesh
    rng = np.random.RandomState(seed)
    d = rng.normal(size=(nrays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1)[:, None]
    o = np.zeros((nrays, 3), np.float32)
    t = time.time()
    res = intersect_mesh(jnp.asarray(o), jnp.asarray(d), geom)
    jax.block_until_ready(res['triangle'])
    t_gpu = time.time() - t
    t = time.time()
    ref = intersect_mesh(_on_cpu(o), _on_cpu(d), _on_cpu(geom))
    jax.block_until_ready(ref['triangle'])
    t_cpu = time.time() - t
    check(not np.asarray(res['incomplete']).any(),
          '%s: card left rays incomplete' % label)
    ok, n_mis, max_rel = compare_hits(res['triangle'], res['distance'],
                                      ref['triangle'], ref['distance'])
    log('compare', 'intersect_mesh %s, %d rays: %d triangle-id '
        'mismatches, max rel distance err %.2e where ids agree '
        '(card %.1f s, CPU %.1f s incl. compile)'
        % (label, nrays, n_mis, max_rel, t_gpu, t_cpu))
    check(ok, 'intersect_mesh %s outside tolerance' % label)


def compare_drivers(geom, nphotons=1 << 12, seed=2):
    """Fused driver vs the compacting reference driver on the card.
    Each new batch shape compiles the fused driver anew, so the tiny
    demo phases share one small shape."""
    import jax
    from chroma_jax import event
    from chroma_jax.ops import photon as photon_ops
    from chroma_jax.ops.fused import propagate_fused
    photons = _bomb(nphotons, seed)
    t = time.time()
    out_f, _ = propagate_fused(photon_ops.upload_photons(photons), geom,
                               jax.random.PRNGKey(seed))
    # min_bucket=n: one early-exiting round over the whole batch, so
    # the reference compiles once instead of once per bucket size
    out_c, _ = photon_ops.propagate_compacting(
        photon_ops.upload_photons(photons), geom,
        jax.random.PRNGKey(seed + 1), min_bucket=nphotons)
    bits = [(n, getattr(event, n)) for n in FLAG_NAMES]
    ok, rows = compare_fractions(np.asarray(out_f['flags']),
                                 np.asarray(out_c['flags']), bits)
    for name, fa, fb, pull in rows:
        log('compare', 'fused vs compacting %-14s %.4f vs %.4f '
            '(%.2f sigma)' % (name, fa, fb, pull))
    log('compare', 'fused vs compacting, %d photons: %s (%.1f s)'
        % (nphotons, 'ok' if ok else 'FAIL', time.time() - t))
    check(ok, 'fused and compacting drivers disagree beyond 5 sigma')


def compare_daq_on_cpu(sim, gp, seed=3):
    import jax
    from chroma_jax.ops.daq import run_daq
    gg = sim.gpu_geometry
    key = jax.random.PRNGKey(seed)
    res = run_daq(gp.state, gg.geom, gg.det, key, gg.nchannels)
    ref = run_daq(_on_cpu(gp.state), _on_cpu(gg.geom), _on_cpu(gg.det),
                  _on_cpu(key), gg.nchannels)
    ok, n_mis, rel = compare_daq(np.asarray(res['t']) < 1e8,
                                 np.asarray(res['q']),
                                 np.asarray(ref['t']) < 1e8,
                                 np.asarray(ref['q']))
    log('compare', 'DAQ card vs CPU, full demo: %d hit-channel '
        'mismatches, total charge rel err %.2e' % (n_mis, rel))
    check(ok, 'DAQ card vs CPU outside tolerance')


def phase_pdf(sim, nphotons=1 << 12, seed=4):
    t = time.time()
    hitcount, pdf = sim.create_pdf(_bomb(nphotons, seed), 128,
                                   (-0.5, 999.5), 10, (-0.5, 9.5))
    hitcount, pdf = np.asarray(hitcount), np.asarray(pdf)
    check(pdf.size > 0 and np.isfinite(pdf).all() and pdf.sum() > 0
          and hitcount.sum() > 0, 'create_pdf: empty or non-finite')
    log('pdf', 'create_pdf: %d hits over %d channels, pdf %s (%.1f s)'
        % (hitcount.sum(), (hitcount > 0).sum(), pdf.shape,
           time.time() - t))
    t = time.time()
    ev0 = next(sim.simulate(_bomb(nphotons, seed + 1), run_daq=True))
    hc, value, uncert = sim.eval_pdf(
        ev0.channels, _bomb(nphotons // 2, seed + 2), 0.2, (-0.5, 999.5),
        1, (-0.5, 9.5), nreps=2, ndaq=32, min_bin_content=20)
    hc, value, uncert = (np.asarray(x) for x in (hc, value, uncert))
    check(value.size > 0 and np.isfinite(value).all()
          and np.isfinite(uncert).all() and hc.sum() > 0,
          'eval_pdf: empty or non-finite')
    log('pdf', 'eval_pdf: %d channels, %d hits, mean value %.3g (%.1f s)'
        % (value.size, hc.sum(), value.mean(), time.time() - t))


def run_single():
    from chroma_jax import demo
    from chroma_jax.sim import Simulation
    device = phase_device()
    t0 = time.time()
    tiny = Simulation(demo.tiny(), geant4_processes=0, seed=7)
    log('setup', 'tiny demo: %d triangles (%.1f s)'
        % (len(tiny.detector.mesh.triangles), time.time() - t0))
    phase_referee(tiny.gpu_geometry.geom)
    full, gp = phase_full(demo.detector)
    compare_intersect('tiny demo', tiny.gpu_geometry.geom, 1 << 20)
    compare_intersect('full demo', full.gpu_geometry.geom, 1 << 14)
    compare_drivers(tiny.gpu_geometry.geom)
    compare_daq_on_cpu(full, gp)
    phase_pdf(tiny)
    return device


def run_multi(ncards=4, nphotons_per_card=1 << 20, make_detector=None,
              seed=1):
    """The sharded path on ``ncards`` cards, against one card."""
    import __graft_entry__
    from chroma_jax import demo
    from chroma_jax.sim import Simulation
    device = phase_device()
    check(device['count'] == ncards, 'need %d GPUs, found %d'
          % (ncards, device['count']))
    t = time.time()
    __graft_entry__.dryrun_multichip(ncards)
    log('multi', 'dryrun_multichip(%d) closed-form windows ok (%.1f s)'
        % (ncards, time.time() - t))

    t = time.time()
    sim = Simulation((make_detector or demo.detector)(),
                     geant4_processes=0, seed=seed)
    check(sim.mesh is not None and sim.mesh.devices.size == ncards,
          'Simulation did not shard over %d cards' % ncards)
    log('multi', 'setup %.1f s, %d triangles'
        % (time.time() - t, len(sim.detector.mesh.triangles)))
    # one 2^20-photon event per card: the sharded leg digitizes all of
    # them in one batch over the mesh, the one-card leg runs them one
    # batch at a time (the shapes chip_smoke's one-card run compiles)
    n = ncards * nphotons_per_card
    events = [_bomb(nphotons_per_card, seed + i) for i in range(ncards)]
    mesh = sim.mesh
    results = {}
    # the one-card leg runs once, to keep the four-card call short: it
    # compiles the one-card program anew (about three minutes on an
    # H100 at the full demo's shapes)
    for label, m, per_batch, reps in (
            ('%d cards' % ncards, mesh, n, ('first', 'warm')),
            ('1 card', None, nphotons_per_card, ('first',))):
        sim.mesh = m
        for rep in reps:
            t = time.time()
            evs = list(sim.simulate(events, run_daq=True, keep_hits=False,
                                    photons_per_batch=per_batch))
            dt = time.time() - t
            log('multi', '%s, %s call: %.3f s (%.0f photons/s)'
                % (label, rep, dt, n / dt))
        results[label] = (sum(int(ev.channels.hit.sum()) for ev in evs),
                          sum(float(ev.channels.q.sum()) for ev in evs),
                          sum(len(ev.flat_hits) for ev in evs))
        log('multi', '%s: %d hit channels over %d events, total charge '
            '%.1f, %d detected photons'
            % ((label,) + results[label][:1] + (len(evs),)
               + results[label][1:]))
    (hm, qm, _), (hs, qs, _) = results.values()
    ok_h = within_sigma(hm, hs, np.sqrt(hm + hs))
    # per-photon charge is at most 1.5 (demo charge distribution), so
    # var(sum q) <= 1.5 * sum q
    ok_q = within_sigma(qm, qs, np.sqrt(1.5 * (qm + qs)))
    log('multi', 'sharded vs one card: hit channels %d vs %d (%s), total '
        'charge %.1f vs %.1f (%s)' % (hm, hs, 'ok' if ok_h else 'FAIL',
                                      qm, qs, 'ok' if ok_q else 'FAIL'))
    check(ok_h and ok_q, 'sharded and one-card results differ beyond '
          '5 sigma')
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--multi', action='store_true',
                    help='run only the four-card sharded path')
    args = ap.parse_args(argv)
    os.environ.setdefault('CHROMA_JAX_CACHE',
                          os.path.join(ROOT, '.cache', 'chroma'))
    t0 = time.time()
    device = run_multi() if args.multi else run_single()
    log('done', 'all phases passed in %.1f s' % (time.time() - t0))
    print(json.dumps({'ok': True, 'device': device}))


if __name__ == '__main__':
    sys.exit(main())
