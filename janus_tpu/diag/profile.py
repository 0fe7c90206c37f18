"""Profiler integration (SURVEY §5: the planned `jax.profiler` hooks).

The reference has no profiler; its observability stops at StatsTe counters
(radaute.hpp:98-108). Here the tool is the XLA profiler: traces are
written as TensorBoard/Perfetto logdirs showing per-op device time, HLO
fusion boundaries, and host↔device transfers. This module is thin glue —
plus ``marginal_seconds``, the marginal cost of chaining more work inside
one jit, which cancels fixed per-call costs (dispatch, the one transfer).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Callable

import jax
import numpy as np


@contextmanager
def trace(logdir: str, host_tracer_level: int = 2):
    """Capture an XLA profiler trace to ``logdir`` (TensorBoard-viewable).

    Usage::

        with diag.trace("/tmp/jtrace"):
            solve_ivp(...)  # device work in here shows per-op timings
    """
    jax.profiler.start_trace(logdir, create_perfetto_trace=False)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Host-side trace annotation (shows as a named span in the profile)."""
    return jax.profiler.TraceAnnotation(name)


def scope(name: str):
    """Device-side name scope: ops created inside get ``name/`` prefixed in
    HLO, so profiler timelines attribute fused kernels to solver phases.
    Used by the solvers around Newton / LU / error-estimate blocks."""
    return jax.named_scope(name)


def device_memory_stats(device=None) -> dict:
    """Live HBM usage for ``device`` (defaults to the first local device).
    Keys are backend-defined; common: bytes_in_use, peak_bytes_in_use."""
    dev = device if device is not None else jax.local_devices()[0]
    stats = dev.memory_stats()
    return dict(stats) if stats else {}


def marginal_seconds(make_chained: Callable[[int], Callable], *args,
                     n_lo: int = 1, n_hi: int = 6, reps: int = 2) -> float:
    """Marginal per-iteration wall time of a chained jitted computation.

    ``make_chained(n)`` must return a COMPILED callable running n chained
    iterations of the workload inside one jit (perturb inputs between
    iterations so XLA cannot collapse them — see bench.py). Returns
    (t(n_hi) − t(n_lo)) / (n_hi − n_lo), which cancels the fixed per-call
    cost and the single transfer.
    """
    run_lo, run_hi = make_chained(n_lo), make_chained(n_hi)
    np.asarray(run_lo(*args))   # compile + warm
    np.asarray(run_hi(*args))

    def timed(fn):
        best = np.inf
        for _ in range(reps):
            t0 = time.perf_counter()
            np.asarray(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best

    return max((timed(run_hi) - timed(run_lo)) / (n_hi - n_lo), 1e-12)
