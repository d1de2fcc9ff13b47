"""Profile the propagate step on the device: where does time go?

Sections (env PROFILE_SECTIONS, default "C"):
  C  gather cost vs working-set size over the real MBVH table
  A  step split: sort / traversal / physics on a mid-flight state
  B  traversal iteration-cap sweep (lock-step tail exposure)

Usage:  PROFILE_SECTIONS=CAB python -u tools/profile_step.py [tiny|full] [log2_n]
"""
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import gpu, demo
from chroma_jax.cache import Cache
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.benchmark import _isotropic_photons, _sync
from chroma_jax.ops import mbvh as mbvh_ops
from chroma_jax.ops import photon as photon_ops
from chroma_jax.ops.propagate import propagate_step
from chroma_jax import event as ev
from chroma_jax.cache import enable_jax_cache

enable_jax_cache()


def timeit(fn, number=3, warm=1):
    for _ in range(warm):
        _sync(fn())
    ts = []
    for _ in range(number):
        t0 = time.time()
        _sync(fn())
        ts.append(time.time() - t0)
    return min(ts)


def log(msg):
    print(msg, flush=True)


def section_c(rows):
    R = rows.shape[0]
    kk = jax.random.PRNGKey(0)
    ng = 1 << 20

    @jax.jit
    def gbench(rows, ptr):
        def body(i, acc):
            r = rows[(ptr + i) % R]
            return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
        return jax.lax.fori_loop(0, 8, body, jnp.zeros((), jnp.uint32))

    for frac in (0.0001, 0.001, 0.01, 0.1, 1.0):
        hi = max(int(R * frac), 1)
        ptr = jax.random.randint(kk, (ng,), 0, hi, dtype=jnp.int32)
        ptr = ptr.block_until_ready()
        t = timeit(lambda: gbench(rows, ptr), number=2)
        log(f'C gather frac={frac:<7} ws={hi*rows.shape[1]*4/2**20:9.1f}'
            f' MiB: {t/(ng*8)*1e9:.2f} ns/row')

    ptr = jnp.sort(jax.random.randint(kk, (ng,), 0, R, dtype=jnp.int32))
    ptr = ptr.block_until_ready()
    t = timeit(lambda: gbench(rows, ptr), number=2)
    log(f'C gather sorted full-table: {t/(ng*8)*1e9:.2f} ns/row')


def section_e(rows):
    """Gather cost vs row width (k x 760 B fused rows)."""
    kk = jax.random.PRNGKey(0)
    ng = 1 << 19
    for k in (1, 2, 4, 8):
        R = (rows.shape[0] // k)
        wide = rows[:R * k].reshape(R, rows.shape[1] * k)

        @jax.jit
        def gbench(wide, ptr, R=R):
            def body(i, acc):
                r = wide[(ptr + i) % R]
                return acc + jnp.sum(r[:, :4].astype(jnp.uint32))
            return jax.lax.fori_loop(0, 8, body,
                                     jnp.zeros((), jnp.uint32))

        ptr = jax.random.randint(kk, (ng,), 0, R, dtype=jnp.int32)
        ptr = ptr.block_until_ready()
        t = timeit(lambda: gbench(wide, ptr), number=2)
        log(f'E gather width={k * 760:5d} B: {t/(ng*8)*1e9:.2f} ns/row '
            f'({t/(ng*8)*1e9/k:.2f} ns per 760B-equivalent)')


def midflight_state(geom, n):
    photons = _isotropic_photons(n)
    gp = gpu.GPUPhotons(photons)
    state = gp.state
    key = jax.random.PRNGKey(7)
    wo = geom.world_origin
    inv_ext = 1.0 / (geom.world_scale * 65535.0)
    for i in range(3):
        key, sk = jax.random.split(key)
        t0 = time.time()
        state, _ = photon_ops.sort_photons(state, wo, inv_ext)
        state = propagate_step(state, geom, sk, 0)
        _sync(state['pos'])
        log(f'# warm step {i}: {time.time()-t0:.1f}s')
    alive = (np.asarray(state['flags']) & ev.TERMINAL_FLAGS) == 0
    log(f'# after 3 steps: alive={alive.sum()}/{n}')
    state, _ = photon_ops.sort_photons(state, wo, inv_ext)
    return jax.tree_util.tree_map(lambda a: a.block_until_ready(), state)


def section_a(geom, sstate, wo, inv_ext):
    t_sort = timeit(lambda: photon_ops.sort_photons(sstate, wo,
                                                    inv_ext)[0])
    log(f'A sort: {t_sort:.4f}s')
    act = (sstate['flags'] & np.uint32(ev.TERMINAL_FLAGS)) == 0
    t_trav = timeit(lambda: mbvh_ops.intersect_mesh(
        sstate['pos'], sstate['dir'], geom, sstate['last_hit_triangle'],
        active=act))
    log(f'A traversal: {t_trav:.4f}s')
    t_step = timeit(lambda: propagate_step(sstate, geom,
                                           jax.random.PRNGKey(3), 0))
    log(f'A full_step: {t_step:.4f}s  sort={t_sort:.4f} '
        f'trav={t_trav:.4f} physics~={t_step-t_trav:.4f}')


def section_b(geom, sstate):
    act = (sstate['flags'] & np.uint32(ev.TERMINAL_FLAGS)) == 0
    nact = int(np.asarray(act).sum())
    for cap in (8, 16, 32, 64, 65536):
        f = lambda cap=cap: mbvh_ops.intersect_mesh(
            sstate['pos'], sstate['dir'], geom,
            sstate['last_hit_triangle'], active=act, max_iters=cap)
        t = timeit(f, number=2)
        inc = int(np.asarray(f()['incomplete'] & act).sum())
        log(f'B cap={cap:6d}: t={t:.4f}s incomplete={inc}'
            f' ({inc/max(nact,1)*100:.2f}% of {nact})')


def section_d(geom, n):
    """End-to-end: does per-step Morton sorting pay for itself?"""
    for sort_every in (1, 0):
        photons = _isotropic_photons(n, seed=5)
        gp = gpu.GPUPhotons(photons)
        key = jax.random.PRNGKey(11)
        f = lambda se=sort_every: photon_ops.propagate(
            gp.state, geom, key, max_steps=8, sort_every=se)[0]['flags']
        t = timeit(f, number=2)
        log(f'D propagate 8 steps sort_every={sort_every}: {t:.3f}s')


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else 'full'
    nlog2 = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    sections = os.environ.get('PROFILE_SECTIONS', 'C')
    n = 1 << nlog2

    t0 = time.time()
    gg = gpu.GPUDetector.from_table_cache(which)
    if gg is None:
        if which == 'full':
            geo = create_geometry_from_obj(
                Cache().load_geometry('demo_full'))
        else:
            geo = create_geometry_from_obj(demo.tiny)
        gg = gpu.GPUDetector(geo)
        gg.save_table_cache(which)
    geom = gg.geom
    rows = geom.mbvh_rows
    log(f'# detector={which} rows={rows.shape} '
        f'({rows.nbytes/2**30:.2f} GiB) depth={geom.mbvh_depth} n={n} '
        f'pack={time.time()-t0:.0f}s')

    if 'C' in sections:
        section_c(rows)
    if 'E' in sections:
        section_e(rows)
    if 'A' in sections or 'B' in sections:
        wo = geom.world_origin
        inv_ext = 1.0 / (geom.world_scale * 65535.0)
        sstate = midflight_state(geom, n)
        if 'A' in sections:
            section_a(geom, sstate, wo, inv_ext)
        if 'B' in sections:
            section_b(geom, sstate)
    if 'D' in sections:
        section_d(geom, n)


if __name__ == '__main__':
    main()
