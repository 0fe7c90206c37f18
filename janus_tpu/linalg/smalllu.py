"""Unrolled batched LU with partial pivoting for small static D.

The stiff stage matrices are tiny (state dim D ≲ 32) but there are tens of
thousands of them (batch M). XLA's generic linalg path serializes or pads badly
here; instead the elimination unrolls at trace time over the STATIC dimension D,
so every operation is a fused [M, …] elementwise op — the batch axis is the
vector axis. No per-sample loops (the reference's dual solve loops over the
batch in C++, src/cpp/radauted_impl.hpp:1995-2010 — the main perf sin to avoid).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def _swap_rows_onehot(x, k, p, rows_idx):
    """Swap row k (static) with row p (dynamic, per batch) WITHOUT gathers.

    One-hot select/reduce swaps are pure elementwise work that fuses with
    the elimination, where a per-lane dynamic gather would not.
    """
    onehot = rows_idx == p[..., None]                       # [..., D]
    row_p = jnp.sum(jnp.where(onehot[..., None], x, 0.0), axis=-2)
    row_k = x[..., k, :]
    diff_kp = (row_p - row_k)[..., None, :]
    is_k = (rows_idx == k)[:, None]
    return x + is_k * diff_kp - onehot[..., None] * diff_kp


def lu_factor(a, pivot: bool = True):
    """Batched LU (partial pivoting by default).

    a: [..., D, D] → (lu [..., D, D] packed L\\U, piv [..., D] int32 swap
    targets in LAPACK ipiv convention; with pivot=False piv is the identity).
    Fully unrolled over the static D; gather-free (one-hot row swaps).
    """
    d = a.shape[-1]
    lu = a
    pivs = []
    rows_idx = jnp.arange(d)
    for k in range(d):
        if pivot:
            # pivot search as an unrolled select tournament: pairwise
            # where-selects are pure elementwise work (no argmax reduction)
            best_val = jnp.abs(lu[..., k, k])
            p = jnp.full(a.shape[:-2], k, jnp.int32)
            for i in range(k + 1, d):
                cand = jnp.abs(lu[..., i, k])
                better = cand > best_val
                best_val = jnp.where(better, cand, best_val)
                p = jnp.where(better, i, p)
            pivs.append(p)
            lu = _swap_rows_onehot(lu, k, p, rows_idx)
        else:
            pivs.append(jnp.full(a.shape[:-2], k, jnp.int32))
        # eliminate below k
        pivval = lu[..., k, k]
        safe = jnp.where(pivval == 0.0, 1.0, pivval)
        mult = lu[..., :, k] / safe[..., None]
        below = rows_idx > k
        mult = jnp.where(below, mult, 0.0)
        # rank-1 update of the trailing submatrix only — columns < k hold the
        # already-stored multipliers and must not be touched
        upd = mult[..., :, None] * lu[..., k:k + 1, :]
        lu = lu - jnp.where(rows_idx[None, :] >= k, upd, 0.0)
        # store multipliers in the strictly-lower part of column k
        lu = lu.at[..., :, k].set(jnp.where(below, mult, lu[..., :, k]))
    piv = jnp.stack(pivs, axis=-1)
    return lu, piv


def lu_ok(lu, a_scale=None, tol=None):
    """Per-batch regularity check: smallest |pivot| vs matrix scale (the
    reference's U_Sing singular-retry trigger, src/cpp/radaute_impl.hpp:692-704)."""
    d = lu.shape[-1]
    diag = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
    scale = jnp.max(jnp.abs(lu), axis=(-2, -1)) if a_scale is None else a_scale
    if tol is None:
        tol = jnp.finfo(lu.dtype).eps * d * 100
    return (jnp.min(diag, axis=-1) > tol * jnp.maximum(scale, 1e-300)) & \
        jnp.all(jnp.isfinite(diag), axis=-1)


def lu_solve(lu, piv, b):
    """Solve with packed factors. b: [..., D] or [..., D, K]."""
    d = lu.shape[-1]
    vec = b.ndim == lu.ndim - 1
    if vec:
        b = b[..., None]
    # apply row swaps in order (LAPACK ipiv semantics), gather-free
    rows_idx = jnp.arange(d)
    for k in range(d):
        b = _swap_rows_onehot(b, k, piv[..., k], rows_idx)
    # forward substitution (unit lower)
    ys = []
    for i in range(d):
        yi = b[..., i, :]
        for j in range(i):
            yi = yi - lu[..., i, j][..., None] * ys[j]
        ys.append(yi)
    # back substitution
    xs = [None] * d
    for i in reversed(range(d)):
        xi = ys[i]
        for j in range(i + 1, d):
            xi = xi - lu[..., i, j][..., None] * xs[j]
        diag = lu[..., i, i]
        diag = jnp.where(diag == 0.0, 1.0, diag)
        xs[i] = xi / diag[..., None]
    x = jnp.stack(xs, axis=-2)
    return x[..., 0] if vec else x


@partial(jax.custom_jvp, nondiff_argnums=())
def linsolve(a, b):
    """x = A⁻¹ b, batched, with a factorization-reusing JVP.

    Tangent rule dx = A⁻¹(db − dA·x) — the reference's solve_LUdual capability
    (src/cpp/radauted_impl.hpp:1901-1936) as a JAX custom_jvp; under vmapped jvp
    N sensitivity columns cost N extra back-substitutions, zero factorizations.
    """
    lu, piv = lu_factor(a)
    return lu_solve(lu, piv, b)


@linsolve.defjvp
def _linsolve_jvp(primals, tangents):
    a, b = primals
    da, db = tangents
    lu, piv = lu_factor(a)
    x = lu_solve(lu, piv, b)
    if b.ndim == a.ndim - 1:
        rhs = db - jnp.einsum("...ij,...j->...i", da, x)
    else:
        rhs = db - da @ x
    dx = lu_solve(lu, piv, rhs)
    return x, dx


def solve_real_complex(ar, ai, br, bi):
    """Solve (Ar + i·Ai)(xr + i·xi) = br + i·bi without a complex dtype.

    Split-real 2×2-block formulation (the reference already splits real/imag
    the same way, src/python/odesolvers/solvrad.py:22-43); block LU maps onto
    the same unrolled elimination.
    """
    top = jnp.concatenate([ar, -ai], axis=-1)
    bot = jnp.concatenate([ai, ar], axis=-1)
    block = jnp.concatenate([top, bot], axis=-2)
    rhs = jnp.concatenate([br, bi], axis=-1)
    sol = linsolve(block, rhs)
    d = ar.shape[-1]
    return sol[..., :d], sol[..., d:]
