"""Native C++ helpers vs numpy reference implementations."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import native, make
from chroma_jax.bvh.build import morton_codes_3d
from chroma_jax.bvh import mbvh as mbvh_mod

pytestmark = pytest.mark.skipif(native.native() is None,
                                reason='no C++ toolchain')


def test_quantize_and_morton_matches_numpy():
    mesh = make.sphere(10.0, nsteps=12)
    wc, lo, hi, morton = mbvh_mod._leaf_data(mesh)

    tv = mesh.vertices[mesh.triangles]
    origin = wc.world_origin
    scale = wc.world_scale

    def quantize(v):
        return ((v - origin) / scale).astype(np.uint32)

    lo_np = quantize(tv.min(axis=1))
    lo_np[lo_np > 0] -= 1
    hi_np = quantize(tv.max(axis=1)) + 1
    morton_np = morton_codes_3d(quantize(tv.mean(axis=1)))

    # float rounding at the quantization edge may differ by 1 ulp of
    # grid; require >99% exact and never off by more than one cell
    exact = (lo == lo_np).all(axis=1) & (hi == hi_np).all(axis=1)
    assert exact.mean() > 0.95
    assert (np.abs(lo.astype(int) - lo_np.astype(int)) <= 1).all()
    assert (np.abs(hi.astype(int) - hi_np.astype(int)) <= 1).all()


def test_radix_argsort():
    rng = np.random.RandomState(0)
    keys = rng.randint(0, 2 ** 63, 100000, dtype=np.uint64)
    order = native.radix_argsort_u64(keys)
    np.testing.assert_array_equal(keys[order], np.sort(keys))
    # stability: equal keys keep index order
    keys2 = rng.randint(0, 4, 1000).astype(np.uint64)
    order2 = native.radix_argsort_u64(keys2)
    np.testing.assert_array_equal(order2, np.argsort(keys2, kind='stable'))


def test_coarsen_group_matches_numpy():
    rng = np.random.RandomState(1)
    codes = np.sort(rng.randint(0, 2 ** 40, 5000).astype(np.uint64))
    fc_nat, codes_nat = native.coarsen_group(codes, 11.0, 28)
    fc_np, nc_np, codes_np = mbvh_mod._coarsen_group(
        codes.copy(), len(codes), 11.0, branch=28)
    np.testing.assert_array_equal(codes_nat, codes_np)
    np.testing.assert_array_equal(fc_nat, fc_np)


def test_segment_min_max():
    rng = np.random.RandomState(2)
    lo = rng.randint(0, 1000, (100, 3)).astype(np.uint32)
    hi = lo + rng.randint(0, 100, (100, 3)).astype(np.uint32)
    fc = np.array([0, 10, 50], dtype=np.int64)
    nc = np.array([10, 40, 50], dtype=np.int64)
    out_lo, out_hi = native.segment_min_max(lo, hi, fc, nc)
    np.testing.assert_array_equal(out_lo,
                                  np.minimum.reduceat(lo, fc, axis=0))
    np.testing.assert_array_equal(out_hi,
                                  np.maximum.reduceat(hi, fc, axis=0))


def test_mbvh_native_build_valid():
    """End-to-end MBVH build with native helpers stays traversable."""
    from tests.test_mbvh import test_build_covers_all_triangles
    test_build_covers_all_triangles()
