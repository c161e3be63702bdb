"""Where JAX keeps its persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR` wins when it is set; otherwise the cache lives
in `.jax_cache` at the root of the checkout (listed in `.gitignore`). A fixed
path matters: it is part of the cache key, so a moving directory never hits.
Entry points (the apps' `main()`, the bench scripts, `chip_smoke.py`, the
test harness) call `enable()` once, before their first compile.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get(ENV_VAR) or DEFAULT_DIR


def enable(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compilation cache at `cache_dir()`; returns it."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
