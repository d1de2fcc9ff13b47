"""chroma-server: ZMQ photon-propagation service (parity: reference
bin/chroma-server and bin/chroma-server-rat).

Two protocols on a REP socket:
  * pickle (default): recv a Photons object, reply with the propagated
    Photons (photons_end);
  * --rat: the packed-binary protocol spoken by RAT's C++ client
    (uint32 header [nphotons, eventid], 11 double arrays, uint32
    track ids; reply = detected hit photons + channel indices).
"""
import argparse

import numpy as np


class ChromaServer(object):
    """Pickle-protocol propagation server."""

    def __init__(self, address, detector, geant4_processes=0):
        import zmq
        from chroma_jax.sim import Simulation
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.REP)
        self.socket.bind(address)
        self.sim = Simulation(detector,
                              geant4_processes=geant4_processes)

    def serve_forever(self):
        while True:
            photons_in = self.socket.recv_pyobj()
            print('Processing', len(photons_in), 'photons')
            ev = next(self.sim.simulate(photons_in,
                                        keep_photons_end=True))
            self.socket.send_pyobj(ev.photons_end)


class ChromaRATServer(object):
    """Packed-binary protocol server for RAT C++ clients."""

    def __init__(self, address, detector, geant4_processes=0):
        import zmq
        from chroma_jax.sim import Simulation
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.REP)
        self.socket.bind(address)
        self.sim = Simulation(detector,
                              geant4_processes=geant4_processes)

    @staticmethod
    def unpack(msg):
        from chroma_jax.event import Photons
        nphotons, eventid = np.frombuffer(msg[:8], dtype=np.uint32)
        doubles = np.frombuffer(msg[8:8 + 8 * 11 * nphotons],
                                dtype=np.double)
        x, y, z, dx, dy, dz, px, py, pz, wavelen, t = np.split(doubles, 11)
        photons = Photons(np.vstack((x, y, z)).T,
                          np.vstack((dx, dy, dz)).T,
                          np.vstack((px, py, pz)).T, wavelen, t)
        return photons, eventid

    @staticmethod
    def pack(hitphotons, chanidxes, eventid):
        reply = np.asarray([len(hitphotons), eventid],
                           dtype=np.uint32).tobytes()
        p = hitphotons
        for arr in (p.pos[:, 0], p.pos[:, 1], p.pos[:, 2],
                    p.dir[:, 0], p.dir[:, 1], p.dir[:, 2],
                    p.pol[:, 0], p.pol[:, 1], p.pol[:, 2],
                    p.wavelengths, p.t):
            reply += np.asarray(arr, dtype=np.double).tobytes()
        reply += chanidxes.tobytes()
        reply += chanidxes.tobytes()  # track-id standin, as upstream
        return reply

    def serve_forever(self):
        while True:
            msg = self.socket.recv()
            photons, eventid = self.unpack(msg)
            print('Received', len(photons), 'photons for event', eventid)
            ev = next(self.sim.simulate(photons, keep_flat_hits=True,
                                        max_steps=1000))
            hits = ev.flat_hits
            order = np.argsort(hits.channel)
            hits = hits[order]
            self.socket.send(self.pack(hits,
                                       hits.channel.astype(np.uint32),
                                       eventid))


def main(argv=None):
    parser = argparse.ArgumentParser('chroma-server')
    parser.add_argument('detector', help='geometry identifier string')
    parser.add_argument('--address', '-a', default='tcp://*:5024')
    parser.add_argument('--rat', action='store_true',
                        help='speak the packed-binary RAT protocol')
    parser.add_argument('-g', type=int, dest='ngenerators', default=0)
    args = parser.parse_args(argv)

    from chroma_jax.loader import load_geometry_from_string
    print('reticulating splines...')
    detector = load_geometry_from_string(args.detector)
    cls = ChromaRATServer if args.rat else ChromaServer
    server = cls(args.address, detector,
                 geant4_processes=args.ngenerators)
    print('starting chroma-jax server listening on', args.address)
    server.serve_forever()


if __name__ == '__main__':
    main()
