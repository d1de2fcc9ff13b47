"""chroma-sim: particle gun -> simulated events -> output file
(parity: reference bin/chroma-sim)."""
import argparse
import itertools
import sys
import time


def main(argv=None):
    parser = argparse.ArgumentParser('chroma-sim')
    parser.add_argument('detector', help='geometry identifier string')
    parser.add_argument('-o', dest='output_filename', default='out.npz')
    parser.add_argument('-s', type=int, dest='seed', default=None)
    parser.add_argument('-g', type=int, dest='ngenerators', default=1,
                        help='number of photon-generator processes '
                        '(0 = feed photons directly)')
    parser.add_argument('-n', '--nevents', type=int, default=10)
    parser.add_argument('-p', '--particle', default='e-')
    parser.add_argument('-k', '--ke', type=float, default=100.0)
    parser.add_argument('--pos', default='0,0,0')
    parser.add_argument('--dir', default='1,0,0')
    parser.add_argument('--save-photons-beg', action='store_true')
    parser.add_argument('--save-photons-end', action='store_true')
    parser.add_argument('--daq', action='store_true', default=True)
    args = parser.parse_args(argv)

    import numpy as np
    from chroma_jax import loader
    from chroma_jax.sim import Simulation
    from chroma_jax.generator.vertex import constant_particle_gun
    from chroma_jax.io.npz import NpzWriter
    from chroma_jax.log import logger
    import logging
    logging.basicConfig(level=logging.INFO)
    logger.setLevel(logging.INFO)

    detector = loader.load_geometry_from_string(args.detector)
    sim = Simulation(detector, seed=args.seed,
                     geant4_processes=args.ngenerators)

    pos = np.asarray([float(x) for x in args.pos.split(',')])
    direction = np.asarray([float(x) for x in args.dir.split(',')])
    gun = itertools.islice(
        constant_particle_gun(args.particle, pos, direction, args.ke),
        args.nevents)

    if args.output_filename.endswith('.root'):
        from chroma_jax.io.ntuple import NTupleWriter
        writer = NTupleWriter(args.output_filename, detector=detector)
    else:
        writer = NpzWriter(args.output_filename)
        if hasattr(detector, 'channel_index_to_position'):
            writer.set_detector(detector)

    start = time.time()
    nwritten = 0
    for ev in sim.simulate(gun, keep_photons_beg=args.save_photons_beg,
                           keep_photons_end=args.save_photons_end,
                           run_daq=args.daq):
        writer.write_event(ev)
        nwritten += 1
    writer.close()
    elapsed = time.time() - start
    print('Wrote %d events to %s in %.1f s (%.2f ev/s)'
          % (nwritten, args.output_filename, elapsed,
             nwritten / max(elapsed, 1e-9)))


if __name__ == '__main__':
    main()
