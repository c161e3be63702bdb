"""Test harness: run everything on a virtual 8-device CPU mesh so sharding
tests need no accelerator (SURVEY.md section 4 implication (4)), and use the
persistent compilation cache (utils/compile_cache) so repeated runs are fast.

The platform is forced through jax.config rather than the environment, which
still works because backends are initialized lazily on first use."""
import os

import jax

from loc_lib_tpu.utils import compile_cache

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
if os.environ.get("LOC_TESTS_NO_CACHE") != "1":
    compile_cache.enable(min_compile_secs=0.5)

assert jax.device_count() == 8, jax.devices()


import pytest


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """XLA:CPU's compiler segfaults (deterministically, deep in
    backend_compile_and_load / LLVM) once a single process has accumulated
    ~85 tests' worth of compiled programs — the same compile passes in a
    fresh process, with or without the persistent cache. Dropping jax's
    in-memory executable/trace caches at module boundaries keeps the
    compiler's resident state bounded; the persistent disk cache makes the
    re-loads cheap."""
    yield
    jax.clear_caches()
