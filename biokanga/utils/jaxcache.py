"""Persistent XLA compilation cache.

First-jit of the big compiled graphs (chunk build, fused align) costs
seconds to tens of seconds; the persistent cache lets every later
process reuse them.  The cache lives where JAX_COMPILATION_CACHE_DIR
says when that is set, and otherwise at one fixed directory inside the
checkout, <repo>/.jax_cache/ (listed in .gitignore): the path is part of
what makes a later run find the entries again.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".jax_cache"))


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); call
    once before the first jit.  Returns the directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
