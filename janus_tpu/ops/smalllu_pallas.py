"""Batched pivot-free small LU as Pallas kernels for the GPU, through Triton.

The stiff solvers factor and solve tens of thousands of tiny D×D stage
systems per step. Here one Triton program takes a block of ``BLOCK_M``
lanes; every lane's whole elimination is unrolled over the static D and
stays in registers, so a factor (or a solve) is one kernel launch.

Layout: lane-major ``[M, E]`` with E = D·D row-major matrix entries (or D
right-hand-side entries). Triton needs power-of-two block dimensions, so
the wrappers pad E and M up to ones (``padded_shape``) and slice the result
back. Pivot-free: the stage iteration matrices γ/h·M − J it serves are
diagonally dominant in the regimes that select it (``Options.pallas_lu``
requires ``pivoting=False``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

BLOCK_M = 128
NUM_WARPS = 4


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def padded_shape(m: int, e: int, block_m: int = BLOCK_M) -> tuple[int, int]:
    """(rows, cols) of the padded ``[M, E]`` operand: M up to a multiple of
    the lane block, E up to a power of two."""
    return -(-m // block_m) * block_m, _next_pow2(e)


def _pad(x2d, block_m, lane=None):
    """Pad ``[M, E]`` to ``padded_shape``; padded lanes are copies of
    ``lane`` (default zeros) — the identity for matrices, so they stay
    finite."""
    m, e = x2d.shape
    mp, ep = padded_shape(m, e, block_m)
    if ep != e:
        x2d = jnp.pad(x2d, ((0, 0), (0, ep - e)))
    if mp != m:
        row = (jnp.zeros((ep,), x2d.dtype) if lane is None
               else jnp.pad(lane.astype(x2d.dtype), (0, ep - e)))
        x2d = jnp.concatenate([x2d, jnp.broadcast_to(row, (mp - m, ep))])
    return x2d


def _eye_lane(d):
    return jnp.eye(d).reshape(d * d)


def _call(kernel, name, operands, out_cols, dtype, block_m, interpret):
    mp = operands[0].shape[0]
    spec = lambda x: pl.BlockSpec((block_m, x.shape[1]),            # noqa: E731
                                  lambda i: (i, 0))
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((mp, out_cols), dtype),
        grid=(mp // block_m,),
        in_specs=[spec(x) for x in operands],
        out_specs=pl.BlockSpec((block_m, out_cols), lambda i: (i, 0)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name=name,
    )(*operands)


def _factor_kernel(d):
    def kernel(a_ref, lu_ref):
        a = [[a_ref[:, i * d + j] for j in range(d)] for i in range(d)]
        for k in range(d):
            inv = 1.0 / a[k][k]
            for i in range(k + 1, d):
                mlt = a[i][k] * inv
                a[i][k] = mlt
                for j in range(k + 1, d):
                    a[i][j] = a[i][j] - mlt * a[k][j]
        for i in range(d):
            for j in range(d):
                lu_ref[:, i * d + j] = a[i][j]

    return kernel


def _solve_kernel(d):
    def kernel(lu_ref, b_ref, x_ref):
        a = [[lu_ref[:, i * d + j] for j in range(d)] for i in range(d)]
        y = [b_ref[:, i] for i in range(d)]
        for i in range(1, d):                       # unit lower
            for j in range(i):
                y[i] = y[i] - a[i][j] * y[j]
        for i in reversed(range(d)):                # upper
            acc = y[i]
            for j in range(i + 1, d):
                acc = acc - a[i][j] * y[j]
            y[i] = acc / a[i][i]
        for i in range(d):
            x_ref[:, i] = y[i]

    return kernel


@functools.partial(jax.jit, static_argnames=("interpret", "block_m"))
def lu_factor(a, *, interpret: bool = False, block_m: int = BLOCK_M):
    """Packed pivot-free L\\U of ``a [..., D, D]`` (unit lower implied)."""
    batch, d = a.shape[:-2], a.shape[-1]
    m = 1
    for n in batch:
        m *= n
    x = _pad(a.reshape(m, d * d), block_m, _eye_lane(d))
    lu = _call(_factor_kernel(d), "stage_lu_factor", [x], x.shape[1],
               a.dtype, block_m, interpret)
    return lu[:m, :d * d].reshape(a.shape)


@functools.partial(jax.jit, static_argnames=("interpret", "block_m"))
def lu_solve(lu, b, *, interpret: bool = False, block_m: int = BLOCK_M):
    """x with ``A x = b`` from ``lu_factor``'s packed factors; b [..., D]."""
    batch, d = lu.shape[:-2], lu.shape[-1]
    m = 1
    for n in batch:
        m *= n
    lu2 = _pad(lu.reshape(m, d * d), block_m, _eye_lane(d))
    b2 = _pad(b.reshape(m, d), block_m)
    x = _call(_solve_kernel(d), "stage_lu_solve", [lu2, b2], b2.shape[1],
              b.dtype, block_m, interpret)
    return x[:m, :d].reshape(b.shape)
