"""chroma-cam: render a geometry (parity: reference bin/chroma-cam).

With a display: interactive pygame viewer.  Headless (or with -o):
writes a PNG snapshot.  With -i: steps through events from an npz
file, coloring PMTs."""
import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser('chroma-cam')
    parser.add_argument('geometry', help='geometry identifier string')
    parser.add_argument('-o', dest='output', default=None,
                        help='write a PNG snapshot instead of running '
                        'interactively')
    parser.add_argument('--size', default='800x600')
    parser.add_argument('-i', dest='io_file', default=None,
                        help='event file for the event viewer')
    parser.add_argument('--alpha-depth', type=int, default=10)
    parser.add_argument('--hybrid', action='store_true',
                        help='progressive photon-map render '
                        '(reference cuda/hybrid_render.cu)')
    parser.add_argument('--bvh-layer', type=int, default=None,
                        help='overlay this BVH layer as a wireframe')
    parser.add_argument('--tracks', action='store_true',
                        help='with -i: overlay photon tracks')
    args = parser.parse_args(argv)

    from chroma_jax import loader
    from chroma_jax.camera import Camera, EventViewer

    size = tuple(int(x) for x in args.size.split('x'))
    geometry = loader.load_geometry_from_string(args.geometry)

    if args.io_file:
        from chroma_jax.io.npz import NpzReader
        cam = EventViewer(geometry, NpzReader(args.io_file), size=size,
                          alpha_depth=args.alpha_depth)
    else:
        cam = Camera(geometry, size=size, alpha_depth=args.alpha_depth)

    if args.output or not os.environ.get('DISPLAY'):
        out = args.output or 'chroma_camera.png'
        if args.hybrid:
            from PIL import Image
            Image.fromarray(cam.render_hybrid_to_array()).save(out)
        elif args.bvh_layer is not None:
            from PIL import Image
            Image.fromarray(
                cam.render_bvh_to_array(layer=args.bvh_layer)).save(out)
        elif args.tracks and args.io_file:
            cam.snapshot_event(out)
        else:
            cam.snapshot(out)
        print('wrote', out)
    else:
        cam.run()


if __name__ == '__main__':
    main()
