"""Placement of JAX's persistent compilation cache.

Every entry point (``ltjax.run``, ``bench.py``, ``chip_smoke.py``, the
test harness) calls :func:`configure` once before it compiles.  The
cache directory is part of the cache's key, so it must not move
between runs of one checkout:

* ``JAX_COMPILATION_CACHE_DIR`` set: that directory, and no other;
* otherwise ``<checkout>/.jax_cache`` (listed in ``.gitignore``), so a
  run reads and writes nothing outside its checkout.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory :func:`configure` uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def configure(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at :func:`cache_dir`.

    Compilations shorter than ``min_compile_secs`` are not cached.
    Returns the directory.
    """
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
