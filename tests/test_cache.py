"""Cache semantics (model: reference test/test_cache.py)."""
import os

import numpy as np
import pytest

import tests.conftest  # noqa: F401

from chroma_jax import make
from chroma_jax.cache import Cache, GeometryNotFoundError, BVHNotFoundError
from chroma_jax.geometry import Geometry, Solid, vacuum
from chroma_jax.bvh import make_simple_bvh


@pytest.fixture
def cache(tmp_path):
    return Cache(str(tmp_path / 'cache'))


def flat_geometry():
    geo = Geometry(vacuum)
    geo.add_solid(Solid(make.cube(1.0), vacuum, vacuum))
    geo.flatten()
    return geo


def test_creates_directories(tmp_path):
    Cache(str(tmp_path / 'c'))
    assert os.path.isdir(str(tmp_path / 'c' / 'geo'))
    assert os.path.isdir(str(tmp_path / 'c' / 'bvh'))


def test_geometry_round_trip(cache):
    geo = flat_geometry()
    cache.save_geometry('cube', geo)
    assert cache.list_geometry() == ['cube']
    loaded = cache.load_geometry('cube')
    assert len(loaded.mesh.triangles) == len(geo.mesh.triangles)
    assert cache.get_geometry_hash('cube') == geo.mesh.md5()
    cache.remove_geometry('cube')
    assert cache.list_geometry() == []
    with pytest.raises(GeometryNotFoundError):
        cache.load_geometry('cube')


def test_default_geometry(cache):
    geo = flat_geometry()
    cache.save_geometry('cube', geo)
    with pytest.raises(GeometryNotFoundError):
        cache.load_default_geometry()
    cache.set_default_geometry('cube')
    assert cache.load_default_geometry() is not None


def test_bvh_round_trip(cache):
    geo = flat_geometry()
    bvh = make_simple_bvh(geo.mesh, degree=2)
    mesh_hash = geo.mesh.md5()
    assert not cache.exist_bvh(mesh_hash)
    cache.save_bvh(bvh, mesh_hash)
    assert cache.exist_bvh(mesh_hash)
    assert cache.list_bvh(mesh_hash) == ['default']
    loaded = cache.load_bvh(mesh_hash)
    assert len(loaded) == len(bvh)
    cache.save_bvh(bvh, mesh_hash, 'alt')
    assert sorted(cache.list_bvh(mesh_hash)) == ['alt', 'default']
    cache.remove_bvh(mesh_hash, 'alt')
    with pytest.raises(BVHNotFoundError):
        cache.load_bvh(mesh_hash, 'alt')


def test_jax_cache_dir_follows_environment(monkeypatch, tmp_path):
    """$JAX_COMPILATION_CACHE_DIR wins, and then JAX (which reads the
    variable itself) is configured with nothing else."""
    import jax
    from chroma_jax import cache as cache_mod
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda *a: calls.append(a))
    assert cache_mod.jax_cache_dir() == str(tmp_path)
    assert cache_mod.enable_jax_cache() == str(tmp_path)
    assert calls == []


def test_jax_cache_dir_defaults_to_checkout(monkeypatch):
    """Unset, the compile cache lives at one fixed path inside the
    checkout (listed in .gitignore through .cache/)."""
    import jax
    from chroma_jax import cache as cache_mod
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda *a: calls.append(a))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    expected = os.path.join(root, '.cache', 'jax')
    assert cache_mod.jax_cache_dir() == expected
    assert cache_mod.jax_cache_dir() == expected
    assert cache_mod.enable_jax_cache() == expected
    assert calls == [('jax_compilation_cache_dir', expected)]
