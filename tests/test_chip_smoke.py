"""chip_smoke.py on the CPU: it must refuse to run without a GPU, and
its card-vs-reference comparators must accept at their stated
tolerance and reject just past it.  The card phases themselves run
only on the GPU (python chip_smoke.py)."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import tests.conftest  # noqa: F401

import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_refuses_without_gpu(where, tmp_path):
    """On a CPU-only host, and in a directory holding nothing but the
    script, chip_smoke exits non-zero and prints no result line."""
    script = os.path.join(ROOT, 'chip_smoke.py')
    cwd = ROOT
    if where == 'alone':
        shutil.copy(script, tmp_path / 'chip_smoke.py')
        script, cwd = str(tmp_path / 'chip_smoke.py'), str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               CHROMA_JAX_CACHE=str(tmp_path / 'chroma'))
    env.pop('PYTHONPATH', None)
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    if where == 'checkout':
        assert 'no GPU' in out.stderr


def test_compare_hits_tolerance():
    n = 100_000
    tri = np.arange(n, dtype=np.int32)
    dist = np.full(n, 1000.0)
    ok, n_mis, _ = cs.compare_hits(tri, dist, tri, dist)
    assert ok and n_mis == 0

    # 99.99% of ids identical is accepted, one more mismatch is not
    tri_ref = tri.copy()
    tri_ref[:10] = -1
    assert cs.compare_hits(tri, dist, tri_ref, dist)[:2] == (True, 10)
    tri_ref[10] = -1
    assert cs.compare_hits(tri, dist, tri_ref, dist)[:2] == (False, 11)

    # distances within 1e-5 relative where the ids agree
    d = dist.copy()
    d[5] *= 1 + 0.9e-5
    assert cs.compare_hits(tri, d, tri, dist)[0]
    d[5] = dist[5] * (1 + 1.1e-5)
    assert not cs.compare_hits(tri, d, tri, dist)[0]


def test_compare_fractions_tolerance():
    """5 binomial sigma: with 10,000 photons a side at p ~ 0.5, a
    difference of 353 photons is 4.99 sigma and 354 is 5.01 sigma."""
    bit = 4
    a = np.where(np.arange(10_000) < 5_000, bit, 0).astype(np.uint32)

    def sample(k):
        return np.where(np.arange(10_000) < k, bit, 0).astype(np.uint32)

    ok, rows = cs.compare_fractions(a, sample(5_353), [('X', bit)])
    assert ok and 4.9 < rows[0][3] < 5.0
    ok, rows = cs.compare_fractions(a, sample(5_354), [('X', bit)])
    assert not ok and 5.0 < rows[0][3] < 5.1
    # a flag neither sample carries agrees trivially
    assert cs.compare_fractions(a, a, [('Y', 8)])[0]


def test_compare_daq_tolerance():
    hit = np.array([True, False, True, True])
    q = np.array([1000.0, 0.0, 2000.0, 3000.0])
    assert cs.compare_daq(hit, q, hit, q) == (True, 0, 0.0)
    # total charge within 1e-5 relative
    assert cs.compare_daq(hit, q * (1 + 0.9e-5), hit, q)[0]
    assert not cs.compare_daq(hit, q * (1 + 1.1e-5), hit, q)[0]
    # hit channels must match exactly
    other = hit.copy()
    other[1] = True
    ok, n_mis, _ = cs.compare_daq(other, q, hit, q)
    assert not ok and n_mis == 1
