"""Persistent compilation cache location for the command-line entry points.

`JAX_COMPILATION_CACHE_DIR`, when set, is used as it is; otherwise the cache
lives at one fixed, git-ignored path inside the checkout. The test suite
keeps the cache off (tests/conftest.py).
"""

from __future__ import annotations

import os

import jax

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO, ".jax_cache")


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at `compile_cache_dir()`
    and return it."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
