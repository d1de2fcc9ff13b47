"""Minimal fakes of the uproot/awkward surface chroma_jax/io/ntuple.py
uses — uproot is not installed in this image, so these are what keep
the ntuple writer schema code exercised (same pattern as
tests/fake_root.py for PyROOT).

Covered surface: uproot.recreate(path) -> file; file[name] = columns;
file.close(); ak.zip(dict-of-arrays) -> record; ak.Array(list).
Written trees are kept in a registry keyed by path for the test to
read back.
"""
import sys
import types

import numpy as np

FILES = {}


class Record(object):
    """ak.zip stand-in: a named bundle of equal-length columns."""

    def __init__(self, fields):
        self.fields = {k: np.asarray(v) for k, v in fields.items()}
        ns = {len(v) for v in self.fields.values()}
        assert len(ns) <= 1, 'ak.zip requires equal-length columns'

    def __len__(self):
        return len(next(iter(self.fields.values()))) if self.fields \
            else 0

    def __getitem__(self, k):
        return self.fields[k]


class Array(object):
    """ak.Array stand-in: a plain list wrapper (jagged rows)."""

    def __init__(self, rows):
        self.rows = list(rows)

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        return self.rows[i]


class _File(object):
    def __init__(self, path):
        self.path = path
        self.trees = {}
        self.closed = False
        FILES[path] = self

    def __setitem__(self, name, cols):
        assert not self.closed, 'write to closed file'
        self.trees[name] = dict(cols)

    def close(self):
        self.closed = True


def _recreate(path):
    return _File(str(path))


def make_fakes():
    uproot = types.ModuleType('uproot')
    uproot.recreate = _recreate
    awkward = types.ModuleType('awkward')
    awkward.zip = Record
    awkward.Array = Array
    return uproot, awkward


def install():
    uproot, awkward = make_fakes()
    sys.modules['uproot'] = uproot
    sys.modules['awkward'] = awkward
    return uproot, awkward
