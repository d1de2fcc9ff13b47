"""TLAS/BLAS instanced MBVH correctness.

The instanced tree (one shared BLAS per unique solid + a TLAS over
placements, chroma_jax/bvh/mbvh.py build_mbvh_instanced) must agree
with the flat tree built over the flattened mesh.  Small float
differences are expected: the flat build bakes the rigid transform
into float32 vertices while the instanced walk transforms the ray, so
comparisons are tolerance-banded, not bitwise.
"""
import numpy as np
import pytest

import tests.conftest  # noqa: F401
import jax
import jax.numpy as jnp

from chroma_jax import event, make
from chroma_jax.geometry import Geometry, Solid, vacuum
from chroma_jax.detector import Detector
from chroma_jax.demo.optics import r7081hqe_photocathode, water, \
    black_surface
from chroma_jax.transform import make_rotation_matrix
from chroma_jax.loader import create_geometry_from_obj
from chroma_jax.ops.geometry_pack import pack_geometry, pack_detector
from chroma_jax.ops import mbvh as mbvh_ops
from chroma_jax.ops.daq import run_daq
from chroma_jax.ops.fused import propagate_fused
from chroma_jax.ops.propagate import make_photon_state


def _instance_scene(seed=7, nboxes=14, nspheres=4):
    rng = np.random.RandomState(seed)
    b = Solid(make.box(60, 40, 30), vacuum, vacuum)
    s = Solid(make.sphere(25, nsteps=12), vacuum, vacuum)
    geo = Geometry(vacuum)
    for i in range(nboxes):
        rot = make_rotation_matrix(rng.uniform(0, 2 * np.pi),
                                   rng.randn(3))
        geo.add_solid(b, rot, rng.uniform(-400, 400, 3))
    for i in range(nspheres):
        rot = make_rotation_matrix(rng.uniform(0, 2 * np.pi),
                                   rng.randn(3))
        geo.add_solid(s, rot, rng.uniform(-400, 400, 3))
    return create_geometry_from_obj(geo, update_bvh_cache=False)


@pytest.fixture(scope='module')
def packed_pair():
    geo = _instance_scene()
    return (pack_geometry(geo, instancing=False),
            pack_geometry(geo, instancing=True))


def test_instanced_flag(packed_pair):
    from chroma_jax.bvh.mbvh import KIND_ENTRY
    gf, gi = packed_pair
    assert not gf.mbvh_instanced
    assert gi.mbvh_instanced
    # one instance-entry row per placement, sharing 2 unique BLASes
    hdr = np.asarray(gi.mbvh_rows[:, 0])
    assert int(((hdr & KIND_ENTRY) != 0).sum()) == 18
    # (row-count dedup only pays off for big solids; these are tiny,
    # so just check the structure, not the size)


def test_instanced_matches_flat(packed_pair):
    gf, gi = packed_pair
    rng = np.random.RandomState(3)
    n = 4096
    org = rng.uniform(-500, 500, (n, 3)).astype(np.float32)
    d = rng.randn(n, 3).astype(np.float32)
    # aim half the rays at placed solids so the hit sample is dense
    geo = _instance_scene()
    centers = np.asarray(geo.solid_displacements, dtype=np.float32)
    pick = centers[rng.randint(len(centers), size=n // 2)]
    jitter = rng.uniform(-30, 30, (n // 2, 3)).astype(np.float32)
    d[:n // 2] = pick + jitter - org[:n // 2]
    d /= np.linalg.norm(d, axis=1, keepdims=True)

    rf = mbvh_ops.intersect_mesh(jnp.asarray(org), jnp.asarray(d), gf)
    ri = mbvh_ops.intersect_mesh(jnp.asarray(org), jnp.asarray(d), gi)
    tf, ti = np.asarray(rf['triangle']), np.asarray(ri['triangle'])
    df, di = np.asarray(rf['distance']), np.asarray(ri['distance'])
    hit_f, hit_i = tf >= 0, ti >= 0
    # identical hit/miss classification up to grazing-ray float noise
    assert (hit_f == hit_i).mean() > 0.999
    both = hit_f & hit_i
    assert both.sum() > 500
    assert (tf[both] == ti[both]).mean() > 0.999
    agree = both & (tf == ti)
    np.testing.assert_allclose(df[agree], di[agree], rtol=1e-3,
                               atol=1e-3)
    # normals must agree in direction after the rotate-back to world
    nf = np.asarray(rf['normal'])[agree]
    ni = np.asarray(ri['normal'])[agree]
    nf /= np.maximum(np.linalg.norm(nf, axis=1, keepdims=True), 1e-30)
    ni /= np.maximum(np.linalg.norm(ni, axis=1, keepdims=True), 1e-30)
    assert np.abs((nf * ni).sum(1)).min() > 0.999
    # material codes ride the BLAS cluster rows
    mf = np.asarray(rf['material_code'])[agree]
    mi = np.asarray(ri['material_code'])[agree]
    np.testing.assert_array_equal(mf, mi)


def _pmt_array_detector():
    """A small PMT-array detector (the demo pattern: repeated cube
    PMTs facing a central source inside a black sphere)."""
    det = Detector(water)
    det.add_solid(Solid(make.sphere(900.0, nsteps=16), water, water,
                        surface=black_surface))
    pmt = Solid(make.cube(120.0), water, water,
                surface=r7081hqe_photocathode)
    y = np.array([0.0, 1.0, 0.0])
    rng = np.random.RandomState(11)
    for k in range(24):
        direction = rng.randn(3)
        direction /= np.linalg.norm(direction)
        rot = make_rotation_matrix(rng.uniform(0, 2 * np.pi), direction)
        det.add_pmt(pmt, rot, direction * 600.0)
    det.set_time_dist_gaussian(1.5, -7.5, 7.5)
    det.set_charge_dist_gaussian(1.0, 0.1, 0.0, 1.5)
    return create_geometry_from_obj(det, update_bvh_cache=False)


def _bomb_state(n, seed=5):
    rng = np.random.RandomState(seed)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1)[:, None]
    pol = np.cross(rng.normal(size=(n, 3)), dirs).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    return make_photon_state(
        pos=np.zeros((n, 3), np.float32), dir=dirs, pol=pol,
        wavelength=np.full(n, 400.0, np.float32),
        t=np.zeros(n, np.float32))


def test_instanced_propagation_statistics():
    """Full physics through the fused driver: the instanced and flat
    trees must give statistically identical detection fractions."""
    det = _pmt_array_detector()
    gf, detf = pack_detector(det)
    gi = pack_geometry(det, instancing=True)
    assert gi.mbvh_instanced and not gf.mbvh_instanced
    n = 8192
    counts = []
    for geom in (gf, gi):
        out, _ = propagate_fused(_bomb_state(n), geom,
                                 jax.random.PRNGKey(42), max_steps=20)
        flags = np.asarray(out['flags'])
        counts.append(int(((flags & event.SURFACE_DETECT) != 0).sum()))
    nf, ni = counts
    assert nf > 50 and ni > 50
    # binomial comparison: same detector, same physics -> within 5 sigma
    p = (nf + ni) / (2.0 * n)
    sigma = np.sqrt(2.0 * n * p * (1 - p))
    assert abs(nf - ni) < 5.0 * sigma + 1, (nf, ni)


def test_run_daq_nevents():
    """Megabatch DAQ: photons accumulate into per-event channel blocks
    keyed by evidx (the sharded Simulation path relies on this)."""
    det = _pmt_array_detector()
    geom, dtab = pack_detector(det)
    n = 4096
    state = _bomb_state(n)
    out, _ = propagate_fused(state, geom, jax.random.PRNGKey(1),
                             max_steps=20)
    # split photons between two events; add an out-of-range marker
    evidx = (np.arange(n) % 2).astype(np.uint32)
    evidx[:16] = 0xFFFFFFFF
    out['evidx'] = jnp.asarray(evidx)
    nch = dtab.nchannels
    chan = run_daq(out, geom, dtab, jax.random.PRNGKey(2), nch,
                   nevents=2)
    t = np.asarray(chan['t'])
    assert t.shape == (2 * nch,)
    hits0 = (t[:nch] < 1e8).sum()
    hits1 = (t[nch:] < 1e8).sum()
    assert hits0 > 0 and hits1 > 0
    # single-event DAQ over the same photons must see the union
    out['evidx'] = jnp.zeros(n, jnp.uint32)
    chan_all = run_daq(out, geom, dtab, jax.random.PRNGKey(2), nch)
    hits_all = (np.asarray(chan_all['t']) < 1e8).sum()
    assert hits_all >= max(hits0, hits1)
