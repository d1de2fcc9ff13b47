"""A minimal fake of the PyROOT surface chroma_jax/io/root.py uses:
std.vector, TFile, TTree with per-Fill branch snapshots.  Lets the
ROOT IO round-trip run (and be verified) without ROOT installed."""
import sys
import types
from array import array


class _Vector(object):
    def __init__(self):
        self._v = []

    def push_back(self, x):
        self._v.append(x)

    def clear(self):
        self._v = []

    def size(self):
        return len(self._v)

    def __getitem__(self, i):
        return self._v[i]

    def __len__(self):
        return len(self._v)


class _Std(object):
    @staticmethod
    def vector(typename):
        return _Vector


_TREES = {}


class _TTree(object):
    def __init__(self, name, title=''):
        self.name = name
        self._branches = {}
        self._entries = []
        _TREES[name] = self

    def Branch(self, name, obj, desc=None):
        self._branches[name] = obj

    def Fill(self):
        snap = {}
        for name, obj in self._branches.items():
            if isinstance(obj, _Vector):
                snap[name] = list(obj._v)
            elif isinstance(obj, array):
                snap[name] = obj[0]
            else:
                snap[name] = obj
        self._entries.append(snap)

    def GetEntries(self):
        return len(self._entries)

    def GetEntry(self, i):
        snap = self._entries[i]
        for name, obj in self._branches.items():
            if isinstance(obj, _Vector):
                obj._v = list(snap[name])
            elif isinstance(obj, array):
                obj[0] = snap[name]

    def __getattr__(self, name):
        branches = self.__dict__.get('_branches', {})
        if name in branches:
            obj = branches[name]
            if isinstance(obj, array):
                return obj[0]
            return obj
        raise AttributeError(name)


class _TFile(object):
    def __init__(self, filename, mode=''):
        self.filename = filename
        if mode == 'RECREATE':
            _TREES.clear()

    def Get(self, name):
        return _TREES.get(name)

    def Write(self):
        pass

    def Close(self):
        pass


def make_fake():
    mod = types.ModuleType('ROOT')
    mod.std = _Std()
    mod.TFile = _TFile
    mod.TTree = _TTree
    return mod


def install():
    fake = make_fake()
    sys.modules['ROOT'] = fake
    return fake
