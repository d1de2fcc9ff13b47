"""Photon-generator pool + ZMQ server tests (model: reference
test/test_generator_photon.py; SURVEY §2.8 P6/P7)."""
import itertools
import threading
import time

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import event
from chroma_jax.demo.optics import water
from chroma_jax.generator.photon import G4ParallelGenerator, HAVE_ZMQ
from chroma_jax.generator.vertex import constant_particle_gun

pytestmark = pytest.mark.skipif(not HAVE_ZMQ, reason='pyzmq missing')


def test_parallel_generator_produces_photons():
    """Electron gun events come back with photons (possibly out of
    order), reference: test_generator_photon.py."""
    gen = G4ParallelGenerator(2, water, base_seed=42)
    gun = constant_particle_gun('e-', (0, 0, 0), (1, 0, 0), 10.0)
    events = list(gen.generate_events(itertools.islice(gun, 6)))
    assert len(events) == 6
    for ev in events:
        assert ev.photons_beg is not None
        assert len(ev.photons_beg) > 0
        assert ev.nphotons == len(ev.photons_beg)
    ids = sorted(ev.id for ev in events)
    assert ids == list(range(6))


def test_server_round_trip():
    """Pickle-protocol propagation server answers with propagated
    photons (model: bin/chroma-server flow, SURVEY §3.5)."""
    import zmq
    from chroma_jax import make
    from chroma_jax.geometry import Solid, Geometry, vacuum
    from chroma_jax.loader import create_geometry_from_obj
    from chroma_jax.cli.server import ChromaServer
    from chroma_jax.generator.photon import photon_bomb

    geo = Geometry(vacuum)
    geo.add_solid(Solid(make.box(100, 100, 100), vacuum, vacuum))
    geo = create_geometry_from_obj(geo, update_bvh_cache=False)

    import uuid
    # unique per run: a stale server process bound to the same ipc path
    # would race for our requests
    address = 'ipc:///tmp/chroma_jax_test_server_' + uuid.uuid4().hex
    server = ChromaServer(address, geo, geant4_processes=0)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()

    ctx = zmq.Context()
    sock = ctx.socket(zmq.REQ)
    sock.connect(address)
    np.random.seed(71)   # photon_bomb samples via global np.random
    photons = photon_bomb(500, 400.0, (0, 0, 0)).photons_beg
    sock.send_pyobj(photons)
    assert sock.poll(120000), 'server did not answer'
    photons_end = sock.recv_pyobj()
    assert len(photons_end) == 500
    # in a surfaceless box essentially every photon exits NO_HIT at
    # the wall; a ray grazing exactly along a face plane can legally
    # exhaust max_steps with no flag set (the reference leaves such
    # photons unflagged too), so demand >= 99% rather than all
    no_hit = (photons_end.flags & event.NO_HIT) > 0
    assert no_hit.mean() >= 0.99, no_hit.mean()
    assert not np.allclose(photons_end.pos, photons.pos)
