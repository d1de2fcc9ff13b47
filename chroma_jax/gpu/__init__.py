"""Device-runtime layer: the JAX equivalent of the reference's PyCUDA
host wrappers (reference: chroma/gpu/*).

Class names and call shapes mirror the reference so existing Chroma
drivers port directly; internally everything is jnp arrays + the
chroma_jax.ops engine.  `rng_states` becomes a splittable threefry key
stream (class RNGStream), and `create_cuda_context` is a no-op kept
for API compatibility.
"""
import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops.geometry_pack import pack_geometry, pack_detector
from chroma_jax.ops import photon as photon_ops
from chroma_jax.ops import mbvh as mbvh_ops
from chroma_jax.ops.daq import GPUDaq, GPUChannels, run_daq
from chroma_jax.ops.pdf import GPUPDF, GPUKernelPDF

__all__ = ['GPUGeometry', 'GPUDetector', 'GPUPhotons', 'GPUDaq',
           'GPUChannels', 'GPUPDF', 'GPUKernelPDF', 'RNGStream',
           'create_cuda_context', 'get_rng_states']


class RNGStream(object):
    """Splittable counter-based RNG key stream (replaces the persistent
    curand XORWOW state array, reference: chroma/gpu/tools.py:75)."""

    def __init__(self, seed=0):
        self.key = jax.random.PRNGKey(seed)

    def next(self):
        self.key, sub = jax.random.split(self.key)
        return sub


def get_rng_states(size=None, seed=1):
    """API-compatible RNG construction; size is ignored (threefry keys
    are counter-based, not per-thread)."""
    return RNGStream(seed)


def create_cuda_context(device=None):
    """No-op placeholder: XLA owns the device; kept for porting ease."""
    class _Ctx(object):
        def pop(self):
            pass
    return _Ctx()


class GPUGeometry(object):
    """Packed device geometry (reference: chroma/gpu/geometry.py)."""

    def __init__(self, geometry, wavelengths=None, times=None,
                 print_usage=False):
        self.geometry = geometry
        self.geom = pack_geometry(geometry, wavelengths=wavelengths,
                                  times=times)
        self.det = None
        self.solid_id_map = self.geom.solid_id_map
        if print_usage:
            self.print_device_usage()

    def device_usage_str(self):
        total = sum(a.size * a.dtype.itemsize
                    for a in jax.tree_util.tree_leaves(self.geom))
        return 'geometry tables: %.1f MB' % (total / 1e6)

    def print_device_usage(self):
        print(self.device_usage_str())

    def color_solids(self, solid_hit, colors):
        """Recolor all triangles of hit solids (reference:
        chroma/gpu/geometry.py color_solids)."""
        solid_hit = np.asarray(solid_hit)
        colors = np.asarray(colors, dtype=np.uint32)
        tri_solid = np.asarray(self.geom.solid_id_map)
        mask = solid_hit[tri_solid]
        new_colors = np.where(mask, colors[tri_solid],
                              np.asarray(self.geom.colors))
        self.geom = self.geom.replace(colors=jnp.asarray(new_colors))


class GPUDetector(GPUGeometry):
    """Geometry + channel maps + readout CDFs (reference:
    chroma/gpu/detector.py)."""

    def __init__(self, detector, wavelengths=None, times=None,
                 print_usage=False):
        self.geometry = detector
        self.geom, self.det = pack_detector(detector,
                                            wavelengths=wavelengths,
                                            times=times)
        self.solid_id_map = self.geom.solid_id_map
        self.nchannels = self.det.nchannels
        if print_usage:
            self.print_device_usage()

    @classmethod
    def from_table_cache(cls, name, detector=None):
        """Construct from the packed-table cache (seconds instead of
        the minutes-long host-geometry load + repack); returns None on
        a cache miss.  ``save_table_cache`` fills the cache."""
        from chroma_jax.ops.table_cache import load_tables
        hit = load_tables(name)
        if hit is None:
            return None
        self = object.__new__(cls)
        self.geometry = detector
        self.geom, self.det = hit
        self.solid_id_map = self.geom.solid_id_map
        self.nchannels = self.det.nchannels if self.det else 0
        return self

    def save_table_cache(self, name):
        from chroma_jax.ops.table_cache import save_tables
        save_tables(name, self.geom, self.det)


class GPUPhotons(object):
    """Device photon batch (reference: chroma/gpu/photon.py GPUPhotons).

    ``ncopies > 1`` replicates the photons for likelihood evaluation."""

    def __init__(self, photons, ncopies=1, copy_flags=True,
                 copy_triangles=True, copy_weights=True):
        state = photon_ops.upload_photons(photons)
        if not copy_flags:
            state['flags'] = jnp.zeros_like(state['flags'])
        if not copy_triangles:
            state['last_hit_triangle'] = \
                jnp.full_like(state['last_hit_triangle'], -1)
        if not copy_weights:
            state['weight'] = jnp.ones_like(state['weight'])

        # pad to the next power of two with terminated photons so the
        # jitted propagate/DAQ kernels see a bounded set of shapes (one
        # compile per bucket instead of one per batch size)
        n = len(photons)
        stride = max(1 << int(np.ceil(np.log2(max(n, 1)))), 32)
        if stride > n:
            pad = stride - n

            def pad_arr(k, v):
                filler = jnp.zeros((pad,) + v.shape[1:], v.dtype)
                if k == 'flags':
                    filler = jnp.full((pad,), event.NO_HIT, jnp.uint32)
                elif k == 'last_hit_triangle':
                    filler = jnp.full((pad,), -1, jnp.int32)
                elif k == 'evidx':
                    filler = jnp.full((pad,), 0xFFFFFFFF, jnp.uint32)
                return jnp.concatenate([v, filler])

            state = {k: pad_arr(k, v) for k, v in state.items()}
        if ncopies > 1:
            state = {k: jnp.tile(v, (ncopies,) + (1,) * (v.ndim - 1))
                     for k, v in state.items()}
        # unique per-slot original indices so the compaction driver can
        # restore upload order (padding/copies must not collide)
        state['index'] = jnp.arange(state['pos'].shape[0],
                                    dtype=jnp.uint32)
        self.state = state
        self.true_nphotons = n
        self.stride = stride
        self.ncopies = ncopies
        self.last_steps = None

    def __len__(self):
        return self.state['pos'].shape[0]

    @property
    def pos(self):
        return self.state['pos']

    def propagate(self, gpu_geometry, rng_states, max_steps=100,
                  use_weights=False, scatter_first=0, track=False,
                  mesh=None, **ignored):
        """Propagate to completion (reference gpu/photon.py:192).

        With ``track=True`` returns (step_photon_ids, step_photons)
        snapshots per step for photon-track debugging.  With ``mesh``
        (a multi-device jax Mesh) the photon axis is sharded across
        the mesh and each device runs the fused loop independently.
        """
        key = rng_states.next() if isinstance(rng_states, RNGStream) \
            else rng_states
        geom = gpu_geometry.geom
        if mesh is not None and mesh.devices.size > 1 and not track:
            from chroma_jax import parallel
            n = self.state['pos'].shape[0]
            state, _ = parallel.pad_to_multiple(
                self.state, int(mesh.devices.size))
            state = parallel.propagate_sharded(
                state, geom, key, mesh, max_steps=max_steps,
                use_weights=use_weights, scatter_first=scatter_first)
            state = photon_ops.unsort_photons(state)
            self.state = {k: v[:n] for k, v in state.items()}
            self.last_steps = None
            return None
        if not track:
            import os
            if os.environ.get('CHROMA_JAX_DRIVER') == 'compacting':
                # previous host-driven round loop, kept for comparison
                self.state, steps = photon_ops.propagate_compacting(
                    self.state, geom, key, max_steps=max_steps,
                    use_weights=use_weights, scatter_first=scatter_first)
                self.last_steps = int(steps)
                return None
            from chroma_jax.ops.fused import propagate_fused
            self.state, srv = propagate_fused(
                self.state, geom, key, max_steps=max_steps,
                use_weights=use_weights, scatter_first=scatter_first)
            # stats[1] counts photon-steps; keep the mean steps/photon
            # for API continuity with the compacting driver's last_steps
            self.last_stats = np.asarray(srv)
            self.last_steps = None
            return None
        # tracking mode: one step per host iteration, snapshot each
        from chroma_jax.ops.propagate import propagate_step
        ids = np.arange(len(self))
        # step 0 snapshot: creation positions, so every track polyline
        # starts at the photon's origin
        step_ids = [ids.copy()]
        step_photons = [photon_ops.download_photons(self.state)]
        for step in range(max_steps):
            key, sk = jax.random.split(key)
            sf = scatter_first if step == 0 else 0
            self.state = propagate_step(self.state, geom, sk, sf,
                                        use_weights=use_weights)
            flags = np.asarray(self.state['flags'])
            alive = (flags & event.TERMINAL_FLAGS) == 0
            snapshot = photon_ops.download_photons(self.state)
            step_ids.append(ids.copy())
            step_photons.append(snapshot)
            if not alive.any():
                break
        return step_ids, step_photons

    def get(self):
        """Download as Photons (padding stripped, copies concatenated)."""
        photons = photon_ops.download_photons(self.state)
        if self.stride == self.true_nphotons:
            return photons
        keep = np.concatenate(
            [np.arange(self.true_nphotons) + i * self.stride
             for i in range(self.ncopies)])
        return photons[keep]

    def select(self, target_flag, start_photon=None, nphotons=None):
        """New GPUPhotons containing photons with ``target_flag`` set
        (reference gpu/photon.py select: count+copy compaction).

        The result is padded to the next power of two with terminal
        zero-weight photons so downstream jitted kernels see a bounded
        set of shapes instead of one compile per hit count."""
        sl = slice(start_photon or 0,
                   None if nphotons is None else (start_photon or 0)
                   + nphotons)
        flags = np.asarray(self.state['flags'][sl])
        idx = np.flatnonzero((flags & target_flag) != 0)
        n = len(idx)
        padded = max(1 << int(np.ceil(np.log2(max(n, 1)))), 16)
        pad_idx = np.concatenate([idx, np.zeros(padded - n, np.int64)])
        sub = object.__new__(GPUPhotons)
        sub.state = {k: v[sl][jnp.asarray(pad_idx)]
                     for k, v in self.state.items()}
        sub.state['index'] = jnp.arange(padded, dtype=jnp.uint32)
        if padded > n:
            live = np.arange(padded) < n
            sub.state['weight'] = jnp.where(jnp.asarray(live),
                                            sub.state['weight'], 0.0)
            sub.state['flags'] = jnp.where(
                jnp.asarray(live), sub.state['flags'],
                jnp.uint32(event.NO_HIT))
            sub.state['last_hit_triangle'] = jnp.where(
                jnp.asarray(live), sub.state['last_hit_triangle'], -1)
        sub.true_nphotons = n
        sub.stride = padded
        sub.ncopies = 1
        sub.last_steps = None
        return sub

    def iterate_copies(self):
        for i in range(self.ncopies):
            sl = slice(i * self.stride, (i + 1) * self.stride)
            sub = object.__new__(GPUPhotons)
            sub.state = {k: v[sl] for k, v in self.state.items()}
            sub.true_nphotons = self.true_nphotons
            sub.stride = self.stride
            sub.ncopies = 1
            sub.last_steps = None
            yield sub

    def get_flat_hits(self, gpu_detector, target_flag=event.SURFACE_DETECT,
                      no_map=False, **ignored):
        """Photons that terminated on a detecting channel, with their
        channel index (reference gpu/photon.py get_flat_hits)."""
        state = self.state
        tri = np.asarray(state['last_hit_triangle'])
        flags = np.asarray(state['flags'])
        solid_map = np.asarray(gpu_detector.geom.solid_id_map)
        s2c = np.asarray(gpu_detector.det.solid_id_to_channel_index)
        valid = (tri >= 0) & ((flags & target_flag) != 0)
        channel = np.where(valid, s2c[solid_map[np.maximum(tri, 0)]], -1)
        keep = valid & (channel >= 0)
        idx = np.flatnonzero(keep)
        photons = photon_ops.download_photons(
            {k: v[jnp.asarray(idx)] for k, v in state.items()})
        photons.channel = channel[idx].astype(np.uint32)
        return photons

    def get_hits(self, gpu_detector, **kwargs):
        flat = self.get_flat_hits(gpu_detector, **kwargs)
        return {int(c): flat[flat.channel == c]
                for c in np.unique(flat.channel)}
