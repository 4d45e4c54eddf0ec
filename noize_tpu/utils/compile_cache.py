"""Persistent XLA compile cache — the one place that chooses its directory.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set.  Otherwise the cache
lives in ``.jax_cache/`` at the checkout root (listed in ``.gitignore``):
a fixed path, because the path is part of the cache key, and one inside
the checkout, so nothing is written around it.  Tests, ``bench.py``,
``chip_smoke.py``, the examples and the scripts all call
``enable_compile_cache`` instead of naming a directory themselves.
"""

from __future__ import annotations

import os
import pathlib

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: the checkout root: the directory that holds the ``noize_tpu`` package
CHECKOUT_ROOT = pathlib.Path(__file__).resolve().parents[2]


def cache_dir() -> str:
    """The compile-cache directory: ``$JAX_COMPILATION_CACHE_DIR`` or
    ``<checkout>/.jax_cache``."""
    return os.environ.get(ENV_VAR) or str(CHECKOUT_ROOT / ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``;
    returns the directory."""
    import jax

    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    return path
