"""Persistent XLA compile cache for the entry points.

Importing the library sets nothing; each entry point (``chip_smoke.py``,
``bench.py``, the drivers' ``main``) calls :func:`enable_compile_cache`
once before it compiles.
"""

from __future__ import annotations

import os
from pathlib import Path

# fixed so that every process of a checkout finds what earlier ones
# cached: the directory is part of the cache key
REPO_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Return the directory JAX caches compiled programs in.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as JAX reads it
    and nothing else is set; otherwise the cache goes to ``.jax_cache``
    at the root of the checkout."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE))
    return str(REPO_CACHE)
