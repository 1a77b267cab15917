"""Persistent XLA compilation cache setup.

The batched kernels compile per (lane-count, output-size) shape;
caching compiled executables on disk makes every process after the
first start warm.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and no other path is set here; otherwise the cache is
the fixed ``.jax_cache`` directory of this checkout, so every later
process of the same checkout finds what earlier ones stored.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"

_done = False


def enable_compilation_cache() -> None:
    global _done
    if _done:
        return
    _done = True
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
