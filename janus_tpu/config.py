"""Platform policy: the one module that looks at the device.

Every choice that depends on where the program runs is made here, and the
solvers, the benchmark and the examples ask for it instead of testing a
platform string of their own:

- ``backend()`` / ``device_kind()``: what JAX runs on;
- ``solver_dtype()``: the default float dtype (f64 on the GPU and the CPU;
  the reference's dtype, native on the H100). ``Options(compensated=True)``
  in f32 stays available to callers that choose it;
- ``use_stage_lu_kernel(opts)``: whether the stage factor/solve runs the
  Pallas kernel (``Options.pallas_lu``; GPU only, raises elsewhere);
- ``tridiag_method()``: Thomas scans or parallel cyclic reduction for the
  tridiagonal stage solves;
- ``enable_compile_cache()``: JAX's persistent compilation cache, turned on
  by entry points only (never by importing the library).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

SUPPORTED_BACKENDS = ("gpu", "cpu")
# the fixed in-checkout cache used when JAX_COMPILATION_CACHE_DIR is unset
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[1] / ".jax_cache"


def backend() -> str:
    """JAX's default backend: 'gpu' or 'cpu' (anything else raises)."""
    b = jax.default_backend()
    if b not in SUPPORTED_BACKENDS:
        raise RuntimeError(f"unsupported JAX backend {b!r}; this library "
                           f"runs on {SUPPORTED_BACKENDS}")
    return b


def device_kind() -> str:
    return jax.devices()[0].device_kind


def enable_x64(on: bool = True) -> None:
    """Enable float64 globally (needed for rtol below ~1e-8)."""
    jax.config.update("jax_enable_x64", on)


def solver_dtype(platform: str | None = None):
    """The policy dtype for solver state on ``platform`` (default: the
    current backend). Callers that adopt it call ``enable_x64()`` first."""
    import jax.numpy as jnp

    platform = platform or backend()
    if platform not in SUPPORTED_BACKENDS:
        raise ValueError(f"no dtype policy for platform {platform!r}")
    return jnp.float64


def use_default_dtype():
    """Adopt the policy dtype (enabling x64 when it is f64); returns it."""
    import jax.numpy as jnp

    dtype = solver_dtype()
    if dtype == jnp.float64:
        enable_x64()
    return dtype


def use_stage_lu_kernel(opts, platform: str | None = None) -> bool:
    """Whether the LU stage solves run the Pallas kernel.

    ``Options.pallas_lu=True`` asks for it; the kernel is compiled for the
    GPU only, so asking for it anywhere else raises instead of silently
    running the plain path.
    """
    if not opts.pallas_lu:
        return False
    platform = platform or backend()
    if platform != "gpu":
        raise ValueError("Options(pallas_lu=True) runs the stage-LU kernel, "
                         f"which exists for the GPU only (backend is "
                         f"{platform!r}); drop pallas_lu")
    if opts.pivoting:
        raise ValueError("Options(pallas_lu=True) needs pivoting=False "
                         "(the kernel is pivot-free)")
    return True


def tridiag_method(platform: str | None = None) -> str:
    """'thomas' (two sequential scans, fewest FLOPs) or 'pcr' (parallel
    cyclic reduction: log2(N) full-width sweeps, ~8× the FLOPs). PCR on
    the GPU: 22× faster than Thomas on the D=128 MOL cell on an H100
    (chip_smoke phase d); Thomas on the CPU, where the FLOPs decide."""
    platform = platform or backend()
    return "thomas" if platform == "cpu" else "pcr"


def compile_cache_dir(environ=None) -> tuple[Path, bool]:
    """(directory, set_in_code): ``JAX_COMPILATION_CACHE_DIR`` when set —
    JAX reads it itself, so nothing is set in code — else the fixed
    ``<checkout>/.jax_cache``."""
    environ = os.environ if environ is None else environ
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return Path(env), False
    return DEFAULT_CACHE_DIR, True


def enable_compile_cache() -> Path:
    """Turn on the persistent compilation cache (entry points only)."""
    path, set_in_code = compile_cache_dir()
    if set_in_code:
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
