"""ctypes bindings to the native C++ runtime components (native/janus_native.cpp).

Builds the shared library on first use with g++ (no pip/pybind needed) and
caches it next to the source. Provides:
- ``radau5_cpu``: independent single-trajectory CPU Radau5 oracle (used in
  cross-implementation consistency tests and as the bench baseline);
- ``traj_write`` / ``traj_read``: binary trajectory-dataset IO for the NN
  training workflow (the reference's CSV round-trip role).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parents[2] / "native" / "janus_native.cpp"
_LIB = _SRC.with_name("libjanus_native.so")
_lib: Optional[ctypes.CDLL] = None


def _build() -> None:
    # build beside the target and rename, so concurrent builders (test
    # workers) never load a half-written library
    tmp = _LIB.with_name(f".{_LIB.name}.{os.getpid()}")
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", str(_SRC),
           "-o", str(tmp)]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, _LIB)


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    if (not _LIB.exists()
            or _LIB.stat().st_mtime < _SRC.stat().st_mtime):
        _build()
    lib = ctypes.CDLL(str(_LIB))
    lib.radau5_solve_builtin.restype = ctypes.c_int
    lib.radau5_solve_builtin.argtypes = [
        ctypes.c_int, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_double, ctypes.c_double,
        ctypes.c_long, ctypes.POINTER(ctypes.c_long)]
    lib.traj_write.restype = ctypes.c_int
    lib.traj_write.argtypes = [ctypes.c_char_p,
                               ctypes.POINTER(ctypes.c_double),
                               ctypes.c_int64, ctypes.c_int64]
    lib.traj_info.restype = ctypes.c_int
    lib.traj_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
                              ctypes.POINTER(ctypes.c_int64)]
    lib.traj_read.restype = ctypes.c_int
    lib.traj_read.argtypes = [ctypes.c_char_p,
                              ctypes.POINTER(ctypes.c_double), ctypes.c_int64]
    _lib = lib
    return lib


RHS_VDP = 0


def radau5_cpu(rhs_id: int, t0: float, tf: float, y0, params,
               rtol: float = 1e-8, atol: float = 1e-11,
               max_steps: int = 1000000) -> Tuple[np.ndarray, dict]:
    """Solve one trajectory with the native CPU Radau5 oracle."""
    lib = load()
    # the C solver writes the final state through this pointer — ALWAYS copy
    # (ascontiguousarray aliases an already-contiguous f64 input and would
    # clobber the caller's y0)
    y = np.array(y0, np.float64, order="C", copy=True)
    p = np.ascontiguousarray(np.asarray(params, np.float64))
    stats = np.zeros(6, np.int64)
    rc = lib.radau5_solve_builtin(
        rhs_id, t0, tf, y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        y.size, p.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        rtol, atol, max_steps,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    if rc != 0:
        raise RuntimeError(f"radau5_cpu failed with code {rc}")
    keys = ("nsteps", "naccept", "nreject", "nfev", "njev", "nlu")
    return y, dict(zip(keys, stats.tolist()))


def traj_write(path: str | os.PathLike, data) -> None:
    lib = load()
    arr = np.ascontiguousarray(np.asarray(data, np.float64))
    if arr.ndim != 2:
        raise ValueError("traj_write expects [n_records, record_len]")
    rc = lib.traj_write(str(path).encode(),
                        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                        arr.shape[0], arr.shape[1])
    if rc != 0:
        raise RuntimeError(f"traj_write failed with code {rc}")


def traj_read(path: str | os.PathLike) -> np.ndarray:
    lib = load()
    n = ctypes.c_int64()
    r = ctypes.c_int64()
    rc = lib.traj_info(str(path).encode(), ctypes.byref(n), ctypes.byref(r))
    if rc != 0:
        raise RuntimeError(f"traj_info failed with code {rc}")
    out = np.empty((n.value, r.value), np.float64)
    rc = lib.traj_read(str(path).encode(),
                       out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                       out.size)
    if rc != 0:
        raise RuntimeError(f"traj_read failed with code {rc}")
    return out
