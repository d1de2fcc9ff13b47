"""chroma-geo: geometry cache management (parity: reference
bin/chroma-geo)."""
import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser('chroma-geo')
    sub = parser.add_subparsers(dest='command', required=True)

    p_save = sub.add_parser('save', help='build + cache a geometry')
    p_save.add_argument('geometry', help='@module.func or file.stl')
    p_save.add_argument('name', nargs='?', default=None)

    p_list = sub.add_parser('list', help='list cached geometries')

    p_default = sub.add_parser('default', help='set the default geometry')
    p_default.add_argument('name')

    p_remove = sub.add_parser('remove', help='remove a cached geometry')
    p_remove.add_argument('name')

    p_stat = sub.add_parser('stat', help='show geometry info')
    p_stat.add_argument('name')

    args = parser.parse_args(argv)

    from chroma_jax.cache import Cache
    from chroma_jax import loader
    cache = Cache()

    if args.command == 'list':
        for name in sorted(cache.list_geometry()):
            print(name)
    elif args.command == 'save':
        geometry = loader.load_geometry_from_string(args.geometry)
        name = args.name
        if name is None:
            name = args.geometry.split('.')[-1].strip('@')
        cache.save_geometry(name, geometry)
        print('saved geometry', name)
    elif args.command == 'default':
        cache.set_default_geometry(args.name)
        print('default geometry set to', args.name)
    elif args.command == 'remove':
        cache.remove_geometry(args.name)
    elif args.command == 'stat':
        geometry = cache.load_geometry(args.name)
        print('geometry:  %s' % args.name)
        print('mesh hash: %s' % cache.get_geometry_hash(args.name))
        print('triangles: %d' % len(geometry.mesh.triangles))
        print('vertices:  %d' % len(geometry.mesh.vertices))
        if hasattr(geometry, 'num_channels'):
            print('channels:  %d' % geometry.num_channels())


if __name__ == '__main__':
    main()
