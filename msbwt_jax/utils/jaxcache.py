"""Persistent XLA compilation cache for the entry points.

A cold ``msbwt2-build`` pays the BCR-loop compile; with the persistent
cache every later invocation (same shapes) loads the compiled program
instead. The cache lives in ``$JAX_COMPILATION_CACHE_DIR`` when that is
set, else in one fixed directory inside the checkout (``.jax_cache``,
listed in ``.gitignore``): the path is part of the cache key, so a fixed
path is what lets a later process hit.
"""

from __future__ import annotations

import os

CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` if set and non-empty, else the fixed
    in-checkout directory."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or CHECKOUT_CACHE_DIR


def enable_persistent_cache() -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir` and
    cache every program, however fast it compiled. Idempotent; returns the
    directory."""
    import jax

    path = cache_dir()
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    return path
