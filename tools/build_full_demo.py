"""Build and cache the full demo detector (~10k PMTs, ~42M triangles).

Run once per machine; afterwards bench.py and chroma-sim pick the
packed tables up from the table cache (~/.chroma_jax by default).
With the round-3 instanced MBVH the pack needs only the flattened
scene (10k PMT placements share ONE BLAS), so no multi-minute legacy
BVH build and no 10 GB host-geometry pickle are required.
"""
import logging
import os
import time

logging.basicConfig(level=logging.INFO)


def main():
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    import jax
    try:
        jax.config.update('jax_platforms', 'cpu')
    except RuntimeError:
        pass
    from chroma_jax import demo, gpu

    t0 = time.time()
    geo = demo.detector()
    geo.flatten()
    print('flattened in %.0f s: %d PMTs, %d triangles'
          % (time.time() - t0, geo.num_channels(),
             len(geo.mesh.triangles)))

    t0 = time.time()
    gg = gpu.GPUDetector(geo)
    print('packed in %.0f s: %d MBVH rows (instanced=%s)'
          % (time.time() - t0, gg.geom.mbvh_rows.shape[0],
             gg.geom.mbvh_instanced))
    gg.save_table_cache('full')
    print('table cache "full" saved')


if __name__ == '__main__':
    main()
