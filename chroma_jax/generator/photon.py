"""Photon generation from particle vertices.

The reference delegates photon generation (Cherenkov + scintillation)
to Geant4 running in forked worker processes connected over ZeroMQ
(reference: chroma/generator/photon.py).  That architecture is kept —
it is host-side and device-agnostic — with a pluggable physics backend:

  * ``G4Generator`` (chroma_jax/generator/g4gen.py) when a Geant4
    python environment is present;
  * ``TrackGenerator`` (chroma_jax/generator/trackgen.py) otherwise:
    native physics-grade transport — Bethe-Bloch stopping powers,
    Highland multiple scattering, analytic EM showers, Frank-Tamm
    Cherenkov with the material's dispersion, and GLG4Scint-equivalent
    Birks-quenched scintillation.
"""
import multiprocessing
import os
import threading
import time
import uuid

import numpy as np

from chroma_jax import event
from chroma_jax.event import PARTICLE_MASS_MEV
from chroma_jax.sample import uniform_sphere
from chroma_jax.transform import normalize, get_perp, rotate

try:
    import zmq
    HAVE_ZMQ = True
except ImportError:
    HAVE_ZMQ = False


def photon_bomb(n, wavelength, pos, t0=0.0):
    """An Event of n isotropic monochromatic photons from a point."""
    pos = np.tile(pos, (n, 1)).astype(np.float32)
    dir = uniform_sphere(n).astype(np.float32)
    pol = np.cross(uniform_sphere(n), dir).astype(np.float32)
    pol /= np.linalg.norm(pol, axis=1)[:, None]
    wavelengths = np.full(n, wavelength, dtype=np.float32)
    t = np.full(n, t0, dtype=np.float32)
    return event.Event(photons_beg=event.Photons(
        pos=pos, dir=dir, pol=pol, wavelengths=wavelengths, t=t))


# Physics-grade backend (Bethe-Bloch tracks, EM showers, GLG4Scint
# -equivalent scintillation); kept under the historical name.
from chroma_jax.generator.trackgen import TrackGenerator
ParametricGenerator = TrackGenerator


def _make_generator(material, seed, prefer_g4=True):
    if prefer_g4:
        try:
            from chroma_jax.generator.g4gen import G4Generator
            return G4Generator(material, seed=seed)
        except ImportError:
            pass
    from chroma_jax.generator.trackgen import TrackGenerator
    return TrackGenerator(material, rng=np.random.RandomState(seed))


class GeneratorProcess(multiprocessing.Process):
    """Forked photon-generation worker fed vertices over ZMQ PULL and
    returning photon-filled events over PUSH (reference:
    chroma/generator/photon.py G4GeneratorProcess)."""

    def __init__(self, idnum, material, vertex_socket_address,
                 photon_socket_address, seed=None, tracking=False):
        multiprocessing.Process.__init__(self)
        self.idnum = idnum
        self.material = material
        self.vertex_socket_address = vertex_socket_address
        self.photon_socket_address = photon_socket_address
        self.seed = seed
        self.tracking = tracking
        self.daemon = True

    def run(self):
        gen = _make_generator(self.material, self.seed)
        context = zmq.Context()
        vertex_socket = context.socket(zmq.PULL)
        vertex_socket.connect(self.vertex_socket_address)
        photon_socket = context.socket(zmq.PUSH)
        photon_socket.connect(self.photon_socket_address)

        # ready handshake so the parent knows the world is built
        photon_socket.send_pyobj(('READY', self.idnum))

        while True:
            ev = vertex_socket.recv_pyobj()
            if self.tracking and getattr(gen, 'supports_tracking', False):
                (ev.vertices, ev.photons_beg,
                 ev.photon_parent_trackids) = gen.generate_photons(
                    ev.vertices, tracking=True)
            else:
                ev.photons_beg = gen.generate_photons(ev.vertices)
            ev.nphotons = len(ev.photons_beg)
            photon_socket.send_pyobj(ev)


class G4ParallelGenerator(object):
    """Pool of photon-generation workers (reference:
    chroma/generator/photon.py G4ParallelGenerator).  Events may come
    back out of order."""

    def __init__(self, nprocesses, material, base_seed=None,
                 tracking=False):
        if not HAVE_ZMQ:
            raise ImportError('pyzmq is required for the parallel '
                              'generator pool')
        self.material = material
        if base_seed is None:
            base_seed = np.random.randint(100000000)
        base_address = 'ipc:///tmp/chroma_jax_' + uuid.uuid4().hex
        self.vertex_address = base_address + '.vertex'
        self.photon_address = base_address + '.photon'
        self.processes = [
            GeneratorProcess(i, material, self.vertex_address,
                             self.photon_address, seed=base_seed + i,
                             tracking=tracking)
            for i in range(nprocesses)]
        for p in self.processes:
            p.start()

        self.zmq_context = zmq.Context()
        self.vertex_socket = self.zmq_context.socket(zmq.PUSH)
        self.vertex_socket.bind(self.vertex_address)
        self.photon_socket = self.zmq_context.socket(zmq.PULL)
        self.photon_socket.bind(self.photon_address)

        self.processes_initialized = False

    def _wait_for_ready(self):
        if not self.processes_initialized:
            for _ in self.processes:
                msg = self.photon_socket.recv_pyobj()
                assert msg[0] == 'READY'
            self.processes_initialized = True

    def generate_events(self, events):
        """Yield photon-filled events for an iterable of vertex events.
        Backpressure: at most 2 x nprocesses events in flight."""
        self._wait_for_ready()

        sem = threading.Semaphore(len(self.processes) * 2)
        sent = [0]

        def sender():
            for ev in events:
                sem.acquire()
                self.vertex_socket.send_pyobj(ev)
                sent[0] += 1
            sent.append(True)  # done marker

        t = threading.Thread(target=sender)
        t.daemon = True
        t.start()

        received = 0
        while True:
            done = len(sent) > 1
            if done and received == sent[0]:
                break
            # poll so we never block forever racing the done marker
            if self.photon_socket.poll(100):
                ev = self.photon_socket.recv_pyobj()
                received += 1
                sem.release()
                yield ev
        t.join()

    def __del__(self):
        for p in getattr(self, 'processes', []):
            if p.is_alive():
                p.terminate()
