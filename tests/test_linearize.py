"""Plain linearizations (ops/linearize) against their float64 formulas, the
compile-cache helper, and chip_smoke's refusal to run without a GPU."""
import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from loc_lib_tpu.eval import linearize_ref as lr
from loc_lib_tpu.ops import linearize
from loc_lib_tpu.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("n", [8192, 1000])
@pytest.mark.parametrize("kind", lr.KINDS)
def test_linearization_matches_float64_formula(kind, n):
    """N=8192 is the scan width; 1000 is not a power of two. About a tenth
    of the points are fully masked, and the residual counts must agree
    exactly."""
    args, kw = lr.make_case(kind, n, seed=n)
    fname, ref = lr.case_fns(kind)
    fn = jax.jit(functools.partial(getattr(linearize, fname), **kw))
    err = lr.compare(fn(*map(jnp.asarray, args)), ref(*args, **kw))
    assert lr.within_tolerance(err), err


def test_fully_masked_input_gives_empty_system():
    args, _ = lr.make_case("p2plane_pick", 64)
    q, rows, w, R, t, gate = args
    H, b, n, chi2 = linearize.p2plane_pick(
        q, rows, np.zeros_like(w), R, t, gate)
    assert int(n) == 0 and float(chi2) == 0.0
    assert not np.any(np.asarray(H)) and not np.any(np.asarray(b))


def test_elect_nearest_takes_first_nearest_valid_row():
    """Ties go to the first row, invalid rows never win however near, and a
    point with no valid row gets a zero row and d2 = inf."""
    rows = np.arange(2 * 3 * 2, dtype=np.float32).reshape(2, 3, 2)
    mu = np.zeros((2, 3, 3), np.float32)
    mu[0, :, 2] = [1.0, 1.0, 0.5]
    valid = np.array([[True, True, False], [False, False, False]])
    row, d2 = linearize.elect_nearest(rows, mu, valid,
                                      np.zeros((2, 3), np.float32))
    np.testing.assert_array_equal(np.asarray(row[0]), rows[0, 0])
    assert float(d2[0]) == 1.0
    assert not np.any(np.asarray(row[1])) and np.isinf(float(d2[1]))


@pytest.fixture
def _restore_cache_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])


def test_compile_cache_honours_env_var(monkeypatch, tmp_path,
                                       _restore_cache_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_defaults_into_checkout(monkeypatch,
                                              _restore_cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_chip_smoke_refuses_the_cpu(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    sys.modules.pop("chip_smoke", None)
    import chip_smoke
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)
