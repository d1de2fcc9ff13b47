"""Bit-integrity referee for the propagation engine (bench preflight).

The fused driver moves photons through its pool as packed uint32 rows
(ops/fused._pack), because XLA is free to flush denormal f32 values to
zero, or canonicalize NaN payloads, inside fusions it builds around
float-typed values; history-flag words bitcast to f32 are exactly such
values.  The integer layout prevents that class structurally, but one
silent recurrence would invalidate every statistical test downstream,
so bench.py and chip_smoke.py refuse to report a rate while this check
fails (reference analog: the CUDA engine's propagate.cu asserts on
photon-state corruption rather than reporting a rate from garbage).

The check, per lane width in ``WIDTHS`` — **terminal passthrough**:
photons that are already terminal, with adversarial bit patterns (every
flag bit exercised, denormal floats and NaN payloads in the float
fields), must come out of the FULL fused driver bit-identical to how
they went in.  The physics pass freezes non-alive photons, so the whole
pack -> lane select -> retire scatter -> pool unpack plumbing must be
bit-transparent; any backend flush/canonicalization shows up as
flipped bits.

Run directly:  python -m chroma_jax.referee [tiny|full]
"""
import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops.fused import propagate_fused

WIDTHS = (2048, 4096, 8192)
# small unroll for the referee compiles (separate jit cache entries
# from the production cadence; the persistent compile cache keeps the
# cost to the first run on a host)
_SE = 4


def _adversarial_terminal_state(n, seed=3):
    """Photon state that is terminal on arrival, with bit patterns the
    round-4 bug class corrupts: denormal f32 in the payload floats,
    NaNs in pos/dir, and every flag bit set somewhere."""
    rng = np.random.RandomState(seed)
    bits = rng.randint(0, 1 << 31, size=(n, 16), dtype=np.int64) \
        .astype(np.uint32)
    bits = bits * np.uint32(2) + (np.arange(n)[:, None] & 1).astype(
        np.uint32)  # exercise the sign bit too
    pos = bits[:, 0:3].view(np.float32).copy()
    dirv = bits[:, 3:6].view(np.float32).copy()
    pol = bits[:, 6:9].view(np.float32).copy()
    # lace in exact denormals and NaN payloads
    pos[::7, 0] = np.float32(1.4e-45)            # min subnormal
    pos[1::7, 1] = np.uint32(0x007fffff).view(np.float32)  # max subnormal
    dirv[2::7, 2] = np.float32(np.nan)
    wavelength = bits[:, 9].view(np.float32).copy()
    t = bits[:, 10].view(np.float32).copy()
    weight = np.full(n, np.uint32(0x00000001)).view(np.float32).copy()
    # every photon terminal; history bits cycle through all 32
    flags = (bits[:, 12] | np.uint32(event.BULK_ABSORB)).astype(np.uint32)
    flags[::3] |= np.uint32(event.SURFACE_DETECT)
    return dict(
        pos=jnp.asarray(pos), dir=jnp.asarray(dirv), pol=jnp.asarray(pol),
        wavelength=jnp.asarray(wavelength), t=jnp.asarray(t),
        weight=jnp.asarray(weight), flags=jnp.asarray(flags),
        last_hit_triangle=jnp.asarray(
            bits[:, 13].view(np.int32).copy()),
        evidx=jnp.asarray(bits[:, 14] >> np.uint32(8)),
        index=jnp.arange(n, dtype=jnp.uint32),
    )


def _diff_keys(a, b):
    bad = []
    for k in a:
        # ascontiguousarray: device arrays can come back as strided
        # views (e.g. a transposed lane layout), and ndarray.view
        # refuses non-contiguous reinterprets
        va = np.ascontiguousarray(np.asarray(a[k]))
        vb = np.ascontiguousarray(np.asarray(b[k]))
        if not (va.shape == vb.shape
                and np.array_equal(va.view(np.uint8),
                                   vb.view(np.uint8))):
            nd = int(np.sum(va.view(np.uint32) != vb.view(np.uint32))) \
                if va.shape == vb.shape else -1
            bad.append('%s (%d words differ)' % (k, nd))
    return bad


def run_referee(geom, widths=WIDTHS, verbose=True):
    """Run the terminal-passthrough check against packed geometry
    ``geom``; returns a list of failure strings (empty = pass)."""
    failures = []
    key = jax.random.PRNGKey(11)
    for w in widths:
        n = 2 * w
        state = _adversarial_terminal_state(n)
        ref = {k: np.asarray(v).copy() for k, v in state.items()}
        out, _ = propagate_fused(state, geom, key, max_steps=16,
                                 width=w, service_every=_SE, chains=1)
        jax.block_until_ready(out['flags'])
        bad = _diff_keys(ref, out)
        if bad:
            failures.append('terminal passthrough w=%d: %s'
                            % (w, ', '.join(bad)))
        if verbose:
            print('[referee] terminal passthrough w=%-5d %s'
                  % (w, 'FAIL' if bad else 'ok'), flush=True)
    return failures


def main():
    import sys
    from chroma_jax import gpu, demo
    from chroma_jax.cache import enable_jax_cache
    enable_jax_cache()
    which = sys.argv[1] if len(sys.argv) > 1 else 'tiny'
    gg = gpu.GPUDetector.from_table_cache(which)
    if gg is None:
        geo = demo.detector() if which == 'full' else demo.tiny()
        geo.flatten()
        gg = gpu.GPUDetector(geo)
    failures = run_referee(gg.geom)
    if failures:
        print('[referee] FAILED:')
        for f in failures:
            print('  ' + f)
        sys.exit(1)
    print('[referee] all checks passed')


if __name__ == '__main__':
    main()
