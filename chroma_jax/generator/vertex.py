"""Vertex generators: infinite iterators of Events carrying particle
vertices (parity: chroma/generator/vertex.py)."""
import numpy as np
from itertools import count

from chroma_jax.pi0 import pi0_decay, PI0_MASS
from chroma_jax import event
from chroma_jax.sample import uniform_sphere
from chroma_jax.itertoolset import repeatfunc
from chroma_jax.transform import norm


def from_histogram(h):
    """Draw values from a chroma_jax.histogram.Histogram as a pdf."""
    pdf = h.hist / h.hist.sum()
    cdf = np.cumsum(pdf)
    for x in repeatfunc(np.random.random_sample):
        yield h.bincenters[np.searchsorted(cdf, x)]


def constant(obj):
    while True:
        yield obj


def isotropic():
    while True:
        yield uniform_sphere()


def line_segment(point1, point2):
    while True:
        frac = np.random.uniform(0.0, 1.0)
        yield frac * point1 + (1.0 - frac) * point2


def fill_shell(center, radius):
    for direction in isotropic():
        r = radius * np.random.uniform(0.0, 1.0) ** (1.0 / 3.0)
        yield center + r * direction


def flat(e_lo, e_hi):
    while True:
        yield np.random.uniform(e_lo, e_hi)


def particle_gun(particle_name_iter, pos_iter, dir_iter, ke_iter,
                 t0_iter=None, start_id=0):
    if t0_iter is None:
        t0_iter = constant(0.0)
    for i, particle_name, pos, dir, ke, t0 in zip(
            count(start_id), particle_name_iter, pos_iter, dir_iter,
            ke_iter, t0_iter):
        dir = dir / norm(dir)
        vertex = event.Vertex(particle_name, pos, dir, ke, t0=t0)
        yield event.Event(i, vertex, [vertex])


def pi0_gun(pos_iter, dir_iter, ke_iter, t0_iter=None, start_id=0,
            gamma1_dir_iter=None):
    """pi0 gun: emits the two decay gammas with correct kinematics."""
    if t0_iter is None:
        t0_iter = constant(0.0)
    if gamma1_dir_iter is None:
        gamma1_dir_iter = isotropic()
    for i, pos, dir, ke, t0, gamma1_dir in zip(
            count(start_id), pos_iter, dir_iter, ke_iter, t0_iter,
            gamma1_dir_iter):
        dir = dir / norm(dir)
        primary = event.Vertex('pi0', pos, dir, ke, t0=t0)
        theta_rest = np.arccos(gamma1_dir[2])
        phi_rest = np.arctan2(gamma1_dir[1], gamma1_dir[0])
        (e1, d1), (e2, d2) = pi0_decay(ke + PI0_MASS, dir, theta_rest,
                                       phi_rest)
        g1 = event.Vertex('gamma', pos, d1, e1, t0=t0)
        g2 = event.Vertex('gamma', pos, d2, e2, t0=t0)
        # the decay gammas are what the photon generator propagates;
        # the primary rides along for bookkeeping (the reference passes
        # the gammas in the photons_beg slot, which its generator
        # immediately overwrites: chroma/generator/vertex.py:69)
        ev = event.Event(i, vertices=[g1, g2])
        ev.primary_vertex = primary
        yield ev


def constant_particle_gun(particle_name, pos, dir, ke, t0=0.0, start_id=0):
    """Particle gun with constant parameters; zero direction means
    isotropic."""
    pos = np.asarray(pos)
    dir = np.asarray(dir)
    dir_gen = isotropic() if (dir == 0.0).all() else constant(dir)
    if particle_name == 'pi0':
        return pi0_gun(constant(pos), dir_gen, constant(ke), constant(t0),
                       start_id=start_id)
    return particle_gun(constant(particle_name), constant(pos), dir_gen,
                        constant(ke), constant(t0), start_id=start_id)
