"""Flat ntuple event writer via uproot/awkward (parity:
chroma/io/ntuple.py NTupleWriter — same branch schema: metadata with
channel positions/types, per-event vertex/mcpe/hit records)."""
import numpy as np

try:
    import uproot
    import awkward as ak
    HAVE_UPROOT = True
except ImportError:
    HAVE_UPROOT = False

from chroma_jax.event import Photons


class NTupleWriter(object):
    def __init__(self, filename, detector=None, write_vertices=True,
                 write_mcphotons=False, write_mcpes=True, write_hits=True):
        if not HAVE_UPROOT:
            raise ImportError('uproot/awkward not installed; use '
                              'chroma_jax.io.npz instead.')
        self.file = uproot.recreate(str(filename))
        self._write_vertices = write_vertices
        self._write_mcphotons = write_mcphotons
        self._write_mcpe = write_mcpes
        self._write_hits = write_hits
        self._rows = []
        if detector is not None:
            pos = np.asarray(detector.channel_index_to_position)
            self.file['metadata'] = {
                'n_channels': np.array([len(pos)]),
                'ch_pos_x': [pos[:, 0]], 'ch_pos_y': [pos[:, 1]],
                'ch_pos_z': [pos[:, 2]],
                'ch_types': [np.asarray(
                    detector.channel_index_to_channel_type)],
            }

    @staticmethod
    def _photon_record(photons, write_channel=False):
        rec = {
            'x': np.asarray(photons.pos[:, 0], float),
            'y': np.asarray(photons.pos[:, 1], float),
            'z': np.asarray(photons.pos[:, 2], float),
            'u': np.asarray(photons.dir[:, 0], float),
            'v': np.asarray(photons.dir[:, 1], float),
            'w': np.asarray(photons.dir[:, 2], float),
            't': np.asarray(photons.t, float),
            'wavelength': np.asarray(photons.wavelengths, float),
            'flag': np.asarray(photons.flags),
        }
        if write_channel:
            rec['channel'] = np.asarray(photons.channel)
        return ak.zip(rec)

    def write_event(self, event):
        row = {'evid': event.id}
        if self._write_vertices and event.vertices:
            row['vertex'] = ak.zip({
                'pdg': np.asarray([v.pdgcode for v in event.vertices]),
                'x': np.asarray([v.pos[0] for v in event.vertices], float),
                'y': np.asarray([v.pos[1] for v in event.vertices], float),
                'z': np.asarray([v.pos[2] for v in event.vertices], float),
                'u': np.asarray([v.dir[0] for v in event.vertices], float),
                'v': np.asarray([v.dir[1] for v in event.vertices], float),
                'w': np.asarray([v.dir[2] for v in event.vertices], float),
                't': np.asarray([v.t0 for v in event.vertices], float),
                'ke': np.asarray([v.ke for v in event.vertices], float),
            })
        if self._write_mcphotons:
            if event.photons_beg is not None:
                row['photons_beg'] = self._photon_record(event.photons_beg)
            if event.photons_end is not None:
                row['photons_end'] = self._photon_record(event.photons_end)
        if self._write_mcpe:
            flat = event.flat_hits
            if flat is None and event.hits:
                flat = Photons.join(list(event.hits.values()))
            if flat is not None and len(flat):
                row['mcpe'] = self._photon_record(flat, write_channel=True)
        if self._write_hits and event.channels is not None:
            ids, times, charges = event.channels.hit_channels()
            row['hit'] = ak.zip({'pmt': np.asarray(ids),
                                 'time': np.asarray(times, float),
                                 'charge': np.asarray(charges, float)})
        self._rows.append(row)

    def close(self):
        if self._rows:
            # column-wise assembly; pad heterogeneous keys
            keys = set()
            for r in self._rows:
                keys.update(r)
            cols = {}
            for k in keys:
                vals = [r.get(k) for r in self._rows]
                if all(np.isscalar(v) or v is None for v in vals):
                    cols[k] = np.asarray(
                        [v if v is not None else -1 for v in vals])
                else:
                    empty = ak.Array([])
                    cols[k] = ak.Array([v if v is not None else empty
                                        for v in vals])
            self.file['events'] = cols
        self.file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
