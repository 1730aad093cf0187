"""Persistent compile cache location (utils/jaxcache.py)."""
import os

import jax

from biokanga.utils import jaxcache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_dir_is_used(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert jaxcache.cache_dir() == str(tmp_path / "c")


def test_default_is_fixed_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert jaxcache.cache_dir() == os.path.join(REPO, ".jax_cache")
    assert jaxcache.cache_dir() == jaxcache.cache_dir()   # no per-run part
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_points_jax_at_the_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    before = jax.config.jax_compilation_cache_dir
    try:
        assert jaxcache.enable_persistent_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
        assert (tmp_path / "c").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
