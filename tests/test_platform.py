"""The platform module (janus_tpu.config): dtype policy, stage-LU kernel
choice, tridiagonal dispatch and the compile-cache directory."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from janus_tpu import config
from janus_tpu.solve import Options

REPO = Path(__file__).resolve().parents[1]


def test_backend_and_device_kind_here():
    assert config.backend() == "cpu"
    assert isinstance(config.device_kind(), str) and config.device_kind()


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_dtype_policy_is_f64(platform):
    assert config.solver_dtype(platform) == jnp.float64


def test_dtype_policy_rejects_unknown_platform():
    with pytest.raises(ValueError):
        config.solver_dtype("rocm")


def test_use_default_dtype_enables_x64():
    assert config.use_default_dtype() == jnp.float64
    assert jax.config.jax_enable_x64
    assert jnp.zeros(1).dtype == jnp.float64


@pytest.mark.parametrize("platform", ["gpu", "cpu"])
def test_stage_lu_kernel_off_by_default(platform):
    assert config.use_stage_lu_kernel(Options(), platform) is False


def test_stage_lu_kernel_on_the_gpu():
    opts = Options(pallas_lu=True, pivoting=False)
    assert config.use_stage_lu_kernel(opts, "gpu") is True
    with pytest.raises(ValueError, match="GPU only"):
        config.use_stage_lu_kernel(opts, "cpu")
    with pytest.raises(ValueError, match="pivot"):
        config.use_stage_lu_kernel(opts.replace(pivoting=True), "gpu")


@pytest.mark.parametrize("platform,method", [("cpu", "thomas"),
                                             ("gpu", "pcr")])
def test_tridiag_dispatch(platform, method):
    assert config.tridiag_method(platform) == method


def test_tridiag_auto_follows_the_platform_choice(monkeypatch, rng):
    """tridiag_solve_auto runs whichever method the module picks, and both
    give the same solution."""
    from janus_tpu.linalg import gmres

    n = 16
    dl, du = (jnp.asarray(rng.standard_normal((3, n))) for _ in range(2))
    d = 4.0 + jnp.abs(jnp.asarray(rng.standard_normal((3, n))))
    b = jnp.asarray(rng.standard_normal((3, n)))
    out = {}
    for method in ("thomas", "pcr"):
        monkeypatch.setattr(config, "tridiag_method",
                            lambda platform=None, m=method: m)
        out[method] = gmres.tridiag_solve_auto(dl, d, du, b)
    assert jnp.allclose(out["thomas"], out["pcr"], rtol=1e-12, atol=1e-12)


def test_compile_cache_dir_from_env():
    path, set_in_code = config.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/some/cache"})
    assert path == Path("/some/cache") and set_in_code is False


def test_compile_cache_dir_default_is_fixed_in_checkout():
    path, set_in_code = config.compile_cache_dir({})
    assert set_in_code is True
    assert path == REPO / ".jax_cache" == config.DEFAULT_CACHE_DIR
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


def test_enable_compile_cache_sets_nothing_when_env_is_set(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/env/cache")
    assert config.enable_compile_cache() == Path("/env/cache")
    assert calls == []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert config.enable_compile_cache() == config.DEFAULT_CACHE_DIR
    assert calls == [("jax_compilation_cache_dir",
                      str(config.DEFAULT_CACHE_DIR))]


def test_compiled_entries_land_in_the_env_directory(tmp_path):
    """End to end in a fresh process: with the env var set, the cache
    entries are written there and the in-checkout default stays absent."""
    code = ("import jax, jax.numpy as jnp\n"
            "from janus_tpu import config\n"
            "config.enable_compile_cache()\n"
            "jax.jit(lambda x: jnp.sin(x) @ x.T)(jnp.ones((8, 8)))"
            ".block_until_ready()\n")
    default_existed = config.DEFAULT_CACHE_DIR.exists()
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="0")
    subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                   check=True, timeout=120)
    assert any(tmp_path.iterdir())
    assert config.DEFAULT_CACHE_DIR.exists() == default_existed
