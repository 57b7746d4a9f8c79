"""Persistent XLA compile cache for the entry scripts.

An adaptive-solver train step takes tens of seconds to compile; a persistent
cache lets a later process on the same machine skip that.  The cache key
includes the directory, so the directory must not move between runs:

* ``JAX_COMPILATION_CACHE_DIR`` set — JAX reads it itself; nothing is set in
  code, so whoever sets it decides where the cache lives;
* unset — the fixed ``<checkout>/.jax_cache`` (listed in ``.gitignore``),
  never a temporary, per-process or time-stamped name.

The library never enables a cache on import; entry scripts call
:func:`enable_compile_cache` before their first compile.
"""

from __future__ import annotations

import os

import jax

__all__ = ["compile_cache_dir", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/continuousnormalizingflows_tpu/utils/compile_cache.py -> <checkout>
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> str:
    """The directory the cache uses: the environment's, else the fixed one."""
    return os.environ.get(ENV_VAR) or os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`
    (only when the environment has not already done so) and return it."""
    path = compile_cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
