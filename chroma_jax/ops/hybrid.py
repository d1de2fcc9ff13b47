"""Hybrid photon-map rendering (parity: chroma/cuda/hybrid_render.cu).

Two passes over the same wavefront physics engine:

  * ``update_xyz_lookup`` traces photons from a point light to their
    first DIFFUSE reflection and accumulates cos-weighted RGB into a
    per-triangle irradiance map, split by which side of the surface
    was lit (reference hybrid_render.cu:64 update_xyz_lookup, with the
    float atomics replaced by segment scatter-adds);
  * ``update_xyz_image`` traces camera rays through
    specular/refractive transport to their first diffuse hit and reads
    the map (reference hybrid_render.cu:134 update_xyz_image).

``to_diffuse`` is the reference's photon loop that stops on
REFLECT_DIFFUSE (hybrid_render.cu:19), rebuilt on propagate_step.
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from chroma_jax import event
from chroma_jax.ops.propagate import propagate_step, make_photon_state

# (wavelength nm, rgb weight) samples approximating the eye's response
RGB_WAVELENGTHS = ((685.0, (1.0, 0.0, 0.0)),
                   (545.0, (0.0, 1.0, 0.0)),
                   (445.0, (0.0, 0.0, 1.0)))


@partial(jax.jit, static_argnames=('max_steps',))
def to_diffuse(state, geom, key, max_steps=10):
    """Propagate until the first diffuse reflection (or death).

    Returns (diffuse, tri, outward) — who reflected diffusely, off
    which triangle, and whether the lit side faces along the stored
    geometric normal.
    """
    n = state['pos'].shape[0]
    carry = dict(state=state,
                 done=jnp.zeros(n, bool),
                 tri=jnp.full(n, -1, jnp.int32),
                 outward=jnp.zeros(n, bool),
                 step=jnp.zeros((), jnp.int32),
                 key=key)

    def cond(c):
        flags = c['state']['flags']
        alive = (flags & jnp.uint32(event.TERMINAL_FLAGS)) == 0
        return jnp.any(alive & ~c['done']) & (c['step'] < max_steps)

    def body(c):
        state = c['state']
        key, sk = jax.random.split(c['key'])
        new_state = propagate_step(state, geom, sk, 0)
        newly = (~c['done']
                 & ((new_state['flags'] & jnp.uint32(
                     event.REFLECT_DIFFUSE)) != 0))
        tri = jnp.where(newly, new_state['last_hit_triangle'], c['tri'])
        # side: the diffuse direction points into the half-space the
        # light arrived from; compare with the geometric normal
        tv = geom.tri_vertices[jnp.maximum(tri, 0)]
        gnorm = jnp.cross(tv[:, 1] - tv[:, 0], tv[:, 2] - tv[:, 0])
        outward = jnp.where(
            newly,
            jnp.sum(gnorm * new_state['dir'], axis=1) > 0.0,
            c['outward'])
        done = c['done'] | newly
        # freeze finished photons so later steps skip them
        flags = jnp.where(done & ((new_state['flags'] & jnp.uint32(
            event.TERMINAL_FLAGS)) == 0),
            new_state['flags'] | jnp.uint32(event.NO_HIT),
            new_state['flags'])
        new_state = dict(new_state, flags=flags)
        return dict(state=new_state, done=done, tri=tri, outward=outward,
                    step=c['step'] + 1, key=key)

    out = jax.lax.while_loop(cond, body, carry)
    return out['done'], out['tri'], out['outward']


def _photon_state_to(targets, source, wavelength, key, n):
    dirv = targets - source[None, :]
    dirv = dirv / jnp.linalg.norm(dirv, axis=1, keepdims=True)
    u = jax.random.normal(key, (n, 3))
    pol = jnp.cross(u, dirv)
    pol = pol / jnp.maximum(
        jnp.linalg.norm(pol, axis=1, keepdims=True), 1e-12)
    return make_photon_state(
        pos=jnp.broadcast_to(source, (n, 3)), dir=dirv, pol=pol,
        wavelength=jnp.full(n, wavelength, jnp.float32),
        t=jnp.zeros(n, jnp.float32))


class HybridRenderer(object):
    """Progressive photon-map renderer over a packed geometry."""

    def __init__(self, gpu_geometry, max_steps=10, seed=0):
        self.geom = gpu_geometry.geom
        self.ntriangles = int(self.geom.tri_vertices.shape[0])
        # xyz irradiance per triangle, one table per lit side
        # (reference keeps xyz_lookup1/xyz_lookup2)
        self.lookup = [jnp.zeros((self.ntriangles, 3), jnp.float32),
                       jnp.zeros((self.ntriangles, 3), jnp.float32)]
        self.nlookup_calls = 0
        self.max_steps = max_steps
        self.key = jax.random.PRNGKey(seed)

    def _next(self):
        self.key, sub = jax.random.split(self.key)
        return sub

    def clear_lookup(self):
        self.lookup = [jnp.zeros_like(self.lookup[0]),
                       jnp.zeros_like(self.lookup[1])]
        self.nlookup_calls = 0

    def update_xyz_lookup(self, source_position, chunk=1 << 17):
        """One photon toward a random point of every triangle, traced
        to its diffuse sink (reference hybrid_render.cu:64)."""
        source = jnp.asarray(source_position, jnp.float32)
        tv = self.geom.tri_vertices
        for wavelength, rgb in RGB_WAVELENGTHS:
            rgb = jnp.asarray(rgb, jnp.float32)
            for start in range(0, self.ntriangles, chunk):
                stop = min(start + chunk, self.ntriangles)
                n = stop - start
                k1, k2, k3 = jax.random.split(self._next(), 3)
                a = jax.random.uniform(k1, (n, 1))
                b = jax.random.uniform(k2, (n, 1)) * (1.0 - a)
                c = 1.0 - a - b
                sub = tv[start:stop]
                target = a * sub[:, 0] + b * sub[:, 1] + c * sub[:, 2]
                state = _photon_state_to(target, source, wavelength,
                                         k3, n)

                # visibility: the first boundary must be the targeted
                # triangle, so nearer geometry doesn't double-count
                from chroma_jax.ops import mbvh
                hit = mbvh.intersect_mesh(state['pos'], state['dir'],
                                          self.geom)
                visible = hit['triangle'] == jnp.arange(
                    start, stop, dtype=jnp.int32)

                gnorm = jnp.cross(sub[:, 1] - sub[:, 0],
                                  sub[:, 2] - sub[:, 0])
                gnorm = gnorm / jnp.maximum(
                    jnp.linalg.norm(gnorm, axis=1, keepdims=True), 1e-12)
                cos_theta = jnp.abs(
                    jnp.sum(gnorm * state['dir'], axis=1))

                diffuse, tri, outward = to_diffuse(
                    state, self.geom, self._next(),
                    max_steps=self.max_steps)
                keep = diffuse & visible
                w = jnp.where(keep, cos_theta, 0.0)[:, None] * rgb[None, :]
                idx = jnp.maximum(tri, 0)
                for side in (0, 1):
                    sw = jnp.where((outward == bool(side))[:, None],
                                   w, 0.0)
                    self.lookup[side] = self.lookup[side].at[idx].add(sw)
        self.nlookup_calls += 1

    def render(self, rays_pos, rays_dir, nimages=1):
        """(N,3) float image for camera rays through the photon map
        (reference hybrid_render.cu:134 + process_image)."""
        n = rays_pos.shape[0]
        image = jnp.zeros((n, 3), jnp.float32)
        for wavelength, rgb in RGB_WAVELENGTHS:
            rgb = jnp.asarray(rgb, jnp.float32)
            k = self._next()
            u = jax.random.normal(k, (n, 3))
            pol = jnp.cross(u, rays_dir)
            pol = pol / jnp.maximum(
                jnp.linalg.norm(pol, axis=1, keepdims=True), 1e-12)
            state = make_photon_state(
                pos=rays_pos, dir=rays_dir, pol=pol,
                wavelength=jnp.full(n, wavelength, jnp.float32),
                t=jnp.zeros(n, jnp.float32))
            diffuse, tri, outward = to_diffuse(
                state, self.geom, self._next(), max_steps=self.max_steps)
            idx = jnp.maximum(tri, 0)
            table = jnp.where(outward[:, None],
                              self.lookup[1][idx], self.lookup[0][idx])
            contrib = jnp.where(diffuse[:, None], table * rgb[None, :],
                                0.0)
            image = image + contrib / max(self.nlookup_calls, 1)
        return image / nimages

    def process_image(self, image, scale=1.0):
        """float (N,3) -> uint32 ARGB pixels (hybrid_render.cu:171)."""
        rgb = jnp.clip(np.asarray(image) * scale, 0.0, 1.0)
        rgb = (np.asarray(rgb) * 255.0).astype(np.uint32)
        return (np.uint32(255) << 24 | rgb[:, 0] << 16
                | rgb[:, 1] << 8 | rgb[:, 2])
