"""Native numpy event format: full Event round trip with zero
dependencies.

Schema parity with the reference's ROOT format (reference:
chroma/io/root.py RootReader/RootWriter + io/root.C): photons_beg/
photons_end, flat hits (with channel), per-channel hits map, photon
tracks, vertices (with track steps and children), channel readout, and
a channel-info block all survive a write/read cycle.

Events STREAM to disk as they are written (an .npz archive is a zip of
.npy members, so members append one event at a time — the reference
writer fills its TTree per event the same way, io/root.py:304); only
per-event metadata is kept in memory.
"""
import io as _io
import zipfile

import numpy as np

from chroma_jax import event


_PHOTON_FIELDS = ('pos', 'dir', 'pol', 'wavelengths', 't',
                  'last_hit_triangles', 'flags', 'weights', 'evidx',
                  'channel')


def _pack_photons(prefix, photons, out):
    if photons is None:
        return
    for f in _PHOTON_FIELDS:
        out[prefix + f] = getattr(photons, f)


def _unpack_photons(prefix, data):
    key = prefix + 'pos'
    if key not in data:
        return None
    kwargs = {f: data[prefix + f] for f in _PHOTON_FIELDS
              if prefix + f in data}
    return event.Photons(**kwargs)


def _pack_vertices(prefix, vertices, out):
    if not vertices:
        return
    out[prefix + 'particle'] = np.array(
        [v.particle_name for v in vertices])
    out[prefix + 'pos'] = np.array([v.pos for v in vertices], dtype=float)
    out[prefix + 'dir'] = np.array([v.dir for v in vertices], dtype=float)
    out[prefix + 'ke'] = np.array([v.ke for v in vertices], dtype=float)
    out[prefix + 't0'] = np.array([v.t0 for v in vertices], dtype=float)
    out[prefix + 'trackid'] = np.array([v.trackid for v in vertices],
                                       dtype=np.int32)
    for i, v in enumerate(vertices):
        if v.steps is not None:
            s = v.steps
            out['%ssteps%d_' % (prefix, i)] = np.column_stack(
                [s.x, s.y, s.z, s.t, s.dx, s.dy, s.dz, s.ke, s.edep,
                 s.qedep]).astype(np.float32)
        if v.children:
            _pack_vertices('%schild%d_' % (prefix, i), v.children, out)


def _unpack_vertices(prefix, data):
    key = prefix + 'particle'
    if key not in data:
        return []
    names = data[key]
    tid = data[prefix + 'trackid'] if prefix + 'trackid' in data else None
    vertices = []
    for i in range(len(names)):
        v = event.Vertex(str(names[i]), data[prefix + 'pos'][i],
                         data[prefix + 'dir'][i],
                         float(data[prefix + 'ke'][i]),
                         t0=float(data[prefix + 't0'][i]),
                         trackid=int(tid[i]) if tid is not None else -1)
        skey = '%ssteps%d_' % (prefix, i)
        if skey in data:
            cols = data[skey].T
            v.steps = event.Steps(*cols)
        children = _unpack_vertices('%schild%d_' % (prefix, i), data)
        if children:
            v.children = children
        vertices.append(v)
    return vertices


def _pack_event(ev, evid):
    p = 'ev%d_' % evid
    out = {p + 'id': np.asarray(ev.id)}
    _pack_photons(p + 'beg_', ev.photons_beg, out)
    _pack_photons(p + 'end_', ev.photons_end, out)
    _pack_photons(p + 'flat_hits_', ev.flat_hits, out)
    _pack_vertices(p + 'vertex_', ev.vertices, out)
    if ev.photon_tracks is not None:
        out[p + 'ntracks'] = np.asarray(len(ev.photon_tracks))
        for j, tr in enumerate(ev.photon_tracks):
            _pack_photons('%strack%d_' % (p, j), tr, out)
    if ev.hits is not None:
        out[p + 'hit_channels'] = np.array(sorted(ev.hits), np.int32)
        for c in ev.hits:
            _pack_photons('%shit%d_' % (p, c), ev.hits[c], out)
    if ev.channels is not None:
        out[p + 'chan_hit'] = np.asarray(ev.channels.hit)
        out[p + 'chan_t'] = np.asarray(ev.channels.t)
        out[p + 'chan_q'] = np.asarray(ev.channels.q)
        if ev.channels.flags is not None:
            out[p + 'chan_flags'] = np.asarray(ev.channels.flags)
    return out


def _unpack_event(d, i):
    p = 'ev%d_' % i
    ev = event.Event(id=int(d[p + 'id']))
    ev.photons_beg = _unpack_photons(p + 'beg_', d)
    ev.photons_end = _unpack_photons(p + 'end_', d)
    ev.flat_hits = _unpack_photons(p + 'flat_hits_', d)
    ev.vertices = _unpack_vertices(p + 'vertex_', d)
    if p + 'ntracks' in d:
        ev.photon_tracks = [
            _unpack_photons('%strack%d_' % (p, j), d)
            for j in range(int(d[p + 'ntracks']))]
    if p + 'hit_channels' in d:
        ev.hits = {int(c): _unpack_photons('%shit%d_' % (p, c), d)
                   for c in d[p + 'hit_channels']}
    if p + 'chan_hit' in d:
        flags = d[p + 'chan_flags'] if p + 'chan_flags' in d else None
        ev.channels = event.Channels(d[p + 'chan_hit'],
                                     d[p + 'chan_t'],
                                     d[p + 'chan_q'], flags)
    return ev


class NpzWriter(object):
    """Streams events into an .npz archive as they arrive."""

    def __init__(self, filename):
        if not str(filename).endswith('.npz'):
            filename = str(filename) + '.npz'
        self.filename = filename
        self.zip = zipfile.ZipFile(filename, 'w',
                                   zipfile.ZIP_DEFLATED)
        self.nevents = 0
        self.channel_info = None

    def _write_arrays(self, arrays):
        for name, arr in arrays.items():
            buf = _io.BytesIO()
            np.save(buf, np.asarray(arr), allow_pickle=False)
            self.zip.writestr(name + '.npy', buf.getvalue())

    def set_detector(self, detector):
        """Record channel positions/types (the reference's channel-info
        tree, reference io/root.py:283)."""
        self.channel_info = dict(
            channel_pos=np.asarray(detector.channel_index_to_position),
            channel_type=np.asarray(
                detector.channel_index_to_channel_type))

    def write_event(self, ev):
        self._write_arrays(_pack_event(ev, self.nevents))
        self.nevents += 1

    def close(self):
        meta = {'nevents': np.asarray(self.nevents)}
        if self.channel_info:
            meta.update(self.channel_info)
        self._write_arrays(meta)
        self.zip.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NpzReader(object):
    """Iterates events from an archive written by NpzWriter."""

    def __init__(self, filename):
        if not str(filename).endswith('.npz'):
            filename = str(filename) + '.npz'
        self.data = np.load(filename, allow_pickle=False)
        self.nevents = int(self.data['nevents'])
        self.index = -1

    @property
    def channel_info(self):
        if 'channel_pos' not in self.data:
            return None
        return dict(channel_pos=self.data['channel_pos'],
                    channel_type=self.data['channel_type'])

    def __len__(self):
        return self.nevents

    def __iter__(self):
        for i in range(self.nevents):
            yield self.read_event(i)

    def read_event(self, i):
        return _unpack_event(self.data, i)

    def next(self):
        self.index = (self.index + 1) % self.nevents
        return self.read_event(self.index)

    def prev(self):
        self.index = (self.index - 1) % self.nevents
        return self.read_event(self.index)

    def current(self):
        return self.read_event(max(self.index, 0))
