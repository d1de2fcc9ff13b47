"""The bit-integrity referee (chroma_jax/referee.py) must pass on the
engine as shipped, and its terminal-passthrough check must actually
catch a flush: corrupting one flag word makes it report a failure.
bench.py and chip_smoke.py refuse to report a rate when the referee
fails on the GPU; this keeps the referee itself exercised on the CPU
backend."""
import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax.demo import tiny
from chroma_jax.ops.geometry_pack import pack_geometry
from chroma_jax import referee


@pytest.fixture(scope='module')
def geom():
    geo = tiny()
    geo.flatten()
    return pack_geometry(geo)


def test_terminal_passthrough_passes(geom):
    assert referee.run_referee(geom, widths=(256,), verbose=False) == []


def test_diff_keys_detects_flips():
    a = {'flags': np.arange(8, dtype=np.uint32),
         'pos': np.ones((8, 3), np.float32)}
    b = {k: v.copy() for k, v in a.items()}
    assert referee._diff_keys(a, b) == []
    b['flags'][3] ^= np.uint32(1 << 20)     # one history bit flushed
    bad = referee._diff_keys(a, b)
    assert len(bad) == 1 and bad[0].startswith('flags')


def test_adversarial_state_has_terminal_flags_and_denormals():
    st = referee._adversarial_terminal_state(64)
    from chroma_jax import event
    flags = np.asarray(st['flags'])
    assert ((flags & event.TERMINAL_FLAGS) != 0).all()
    pos = np.asarray(st['pos'])
    sub = np.abs(pos[np.isfinite(pos) & (pos != 0)])
    assert (sub < 1.2e-38).any()            # subnormals present
    assert np.isnan(np.asarray(st['dir'])).any()
