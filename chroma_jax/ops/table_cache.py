"""Fast on-disk cache for packed device tables.

The geometry cache (chroma_jax/cache.py) stores the *host* geometry
(pickled meshes, ~10 GB for the full demo) and re-packing it into
device tables takes minutes.  This cache stores the final
GeometryTables / DetectorTables pytrees as raw .npy files so a
benchmark or server process is table-ready at disk bandwidth.

Keyed by a caller-supplied name (usually the geometry cache name);
static (non-pytree) fields go to a json sidecar.
"""
import json
import os

import numpy as np
import jax.numpy as jnp

from chroma_jax.bvh.mbvh import (LAYOUT_VERSION, BRANCH, ROW_WIDTH,
                                 TARGET_DEGREE, builder_tag)
from chroma_jax.ops.geometry_pack import GeometryTables, DetectorTables

_FORMAT_VERSION = 2


def _cache_dir(name):
    base = os.environ.get('CHROMA_JAX_CACHE',
                          os.path.expanduser('~/.chroma_jax'))
    return os.path.join(base, 'tables', name)


def _static_fields(cls):
    import dataclasses
    return [f.name for f in dataclasses.fields(cls)
            if not f.metadata.get('pytree_node', True)]


def _array_fields(cls):
    import dataclasses
    return [f.name for f in dataclasses.fields(cls)
            if f.metadata.get('pytree_node', True)]


def save_tables(name, geom, det=None):
    """Persist packed tables under CHROMA_JAX_CACHE/tables/<name>."""
    d = _cache_dir(name)
    os.makedirs(d, exist_ok=True)
    meta = {'version': _FORMAT_VERSION, 'has_det': det is not None,
            'mbvh_layout': LAYOUT_VERSION,
            # the env-overridable build knobs change ROW_WIDTH / row
            # layout / tree shape without bumping LAYOUT_VERSION, so
            # they are part of the cache validity key
            'branch': BRANCH, 'row_width': ROW_WIDTH,
            'target_degree': TARGET_DEGREE, 'builder': builder_tag()}
    for prefix, obj in (('geom', geom), ('det', det)):
        if obj is None:
            continue
        cls = type(obj)
        for f in _array_fields(cls):
            np.save(os.path.join(d, '%s_%s.npy' % (prefix, f)),
                    np.asarray(getattr(obj, f)))
        meta[prefix] = {f: getattr(obj, f) for f in _static_fields(cls)}
    with open(os.path.join(d, 'meta.json'), 'w') as f:
        json.dump(meta, f)


def load_tables(name):
    """(geom, det) from the table cache, or None if absent/stale."""
    d = _cache_dir(name)
    metafile = os.path.join(d, 'meta.json')
    if not os.path.exists(metafile):
        return None
    with open(metafile) as f:
        meta = json.load(f)
    # pre-r3 caches carry no knob keys; they were built with the
    # defaults of that era (BRANCH=128, ROW_WIDTH=840, degree=96)
    if meta.get('version') != _FORMAT_VERSION \
            or meta.get('mbvh_layout') != LAYOUT_VERSION \
            or meta.get('branch', 128) != BRANCH \
            or meta.get('row_width', 840) != ROW_WIDTH \
            or meta.get('target_degree', 96) != TARGET_DEGREE \
            or meta.get('builder', 'grid') != builder_tag():
        return None

    def load(prefix, cls):
        kw = dict(meta[prefix])
        for fld in _array_fields(cls):
            path = os.path.join(d, '%s_%s.npy' % (prefix, fld))
            kw[fld] = jnp.asarray(np.load(path))
        return cls(**kw)

    try:
        geom = load('geom', GeometryTables)
        det = load('det', DetectorTables) if meta.get('has_det') else None
    except (FileNotFoundError, TypeError):
        return None
    if geom.mbvh_rows.shape[1] != ROW_WIDTH:
        return None      # stale MBVH layout
    return geom, det
