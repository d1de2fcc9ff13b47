"""Assorted utilities (parity: chroma/tools.py)."""
import functools
import math
import sys
import time

import numpy as np

from chroma_jax.transform import normalize


def count_nonzero(array):
    return int((array != 0).sum())


def filled_array(value, shape, dtype):
    a = np.empty(shape=shape, dtype=dtype)
    a.fill(value)
    return a


def timeit(func):
    """Decorator printing the wall-clock time of each call."""
    @functools.wraps(func)
    def f(*args, **kwargs):
        t0 = time.time()
        retval = func(*args, **kwargs)
        elapsed = time.time() - t0
        print('%s elapsed in %s().' % (str(elapsed), func.__name__))
        return retval
    return f


def profile_if_possible(func):
    """Hook point for line profilers; identity unless kernprof injects
    a global `profile` builtin."""
    prof = getattr(__builtins__, 'profile', None) if not isinstance(
        __builtins__, dict) else __builtins__.get('profile')
    return prof(func) if prof is not None else func


def memoize(func):
    cache = {}

    @functools.wraps(func)
    def f(*args):
        if args not in cache:
            cache[args] = func(*args)
        return cache[args]
    return f


def read_csv(filename):
    """(n,2) float array from a two-column csv/whitespace profile file;
    '#' comments skipped."""
    rows = []
    with open(filename) as f:
        for line in f:
            line = line.split('#')[0].strip()
            if not line:
                continue
            parts = line.replace(',', ' ').split()
            rows.append([float(parts[0]), float(parts[1])])
    return np.asarray(rows, dtype=float)


def offset(points, x):
    """Offset a 2D polyline inward/outward by perpendicular distance
    ``x``: intersect each pair of adjacent offset segments.
    (reference: chroma/tools.py — used to build the inner PMT envelope)"""
    points = np.asarray(points, dtype=float)
    seg = points[1:] - points[:-1]
    # unit normals of each segment (rotate by -90 degrees)
    normals = np.column_stack([seg[:, 1], -seg[:, 0]])
    normals /= np.linalg.norm(normals, axis=1)[:, None]

    a = points[:-1] + normals * x   # offset segment start
    b = points[1:] + normals * x    # offset segment end

    out = [a[0]]
    for i in range(len(seg) - 1):
        # intersect offset segment i with segment i+1
        d1, d2 = seg[i], seg[i + 1]
        p1, p2 = a[i], a[i + 1]
        denom = d1[0] * d2[1] - d1[1] * d2[0]
        if abs(denom) < 1e-12:
            out.append(b[i])
        else:
            t = ((p2[0] - p1[0]) * d2[1] - (p2[1] - p1[1]) * d2[0]) / denom
            out.append(p1 + t * d1)
    out.append(b[-1])
    return np.asarray(out)


def interleave3d(arr, bits):
    """Morton-interleave (n,3) integer coordinates using ``bits`` bits
    per axis."""
    arr = np.asarray(arr, dtype=np.uint64)
    result = np.zeros(len(arr), dtype=np.uint64)
    for i in range(bits):
        for j in range(3):
            result |= ((arr[:, 2 - j] >> np.uint64(i)) & np.uint64(1)) \
                << np.uint64(3 * i + j)
    return result


def argsort_direction(dir):
    """Return ordering of direction vectors that groups nearby
    directions (Morton order on the unit sphere) — improves BVH
    traversal memory coherence (reference: chroma/tools.py:175)."""
    dir = normalize(np.atleast_2d(dir))
    quantized = np.clip(((dir + 1.0) * 0.5 * 1023).astype(np.int64),
                        0, 1023)
    morton = interleave3d(quantized, 10)
    return np.argsort(morton)


def from_film(position, axis1=(0, 0, 1), axis2=(1, 0, 0), size=(800, 600),
              width=35.0, focal_length=18.0):
    """Generate camera rays through a pinhole onto a film plane.

    Returns (positions, directions) with one ray per pixel,
    pixel-major.  (reference: chroma/tools.py:195)
    """
    position = np.asarray(position, dtype=float)
    axis1 = normalize(axis1)
    axis2 = normalize(axis2)
    height = width * size[1] / float(size[0])

    x = np.linspace(-width / 2, width / 2, size[0])
    y = np.linspace(-height / 2, height / 2, size[1])
    xx, yy = np.meshgrid(x, y, indexing='ij')

    normal = np.cross(axis1, axis2)
    # film sits behind the pinhole; rays run from film through pinhole
    grid = (position
            - xx.ravel()[:, None] * axis2
            - yy.ravel()[:, None] * axis1
            - normal * focal_length)
    focal_point = position
    directions = normalize(focal_point - grid)
    return grid, directions


def ufloat_to_str(x):
    msd = -int(math.floor(math.log10(x.std_dev)))
    return '%.*f +/- %.*f' % (msd, round(x.nominal_value, msd),
                              msd, round(x.std_dev, msd))


def enable_debug_on_crash():
    """Drop into pdb on uncaught exceptions (reference:
    chroma/tools.py debugger hook)."""
    def hook(type_, value, tb):
        if hasattr(sys, 'ps1') or not sys.stderr.isatty():
            sys.__excepthook__(type_, value, tb)
        else:
            import traceback
            import pdb
            traceback.print_exception(type_, value, tb)
            pdb.post_mortem(tb)
    sys.excepthook = hook
