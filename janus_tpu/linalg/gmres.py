"""Batched GMRES for the implicit-stage systems of stiff solvers.

The reference swaps PETSc-GMRES closures in place of dense LU for the Radau
stage systems (reference src/python/odesolvers/src/odesolvers/linsolve.py:61-110
``decom_rc_gmres``, consumed by prepare_step.py:36-48) — that is what makes it
usable on method-of-lines PDE lines (examples/cpp/meinhart_pseudo_transient.cpp).
This is the batched equivalent: a fixed-iteration-count right-preconditioned
GMRES(k) whose Arnoldi/Givens recurrences are unrolled at trace time (static
shapes, no data-dependent control flow) and whose inner products are batched
over the M lanes — every lane runs the same k iterations in lockstep, the
work stays batch-wide, and compile time is O(k²) small ops instead of the
unrolled dense LU's O(D²).

Breakdown-safe: zero residual or lucky breakdown produce zero rotations and a
finite (already-converged) solution rather than NaN. Exhaustion-safe: when the
Arnoldi depth exceeds a lane's Krylov dimension (k > N happens routinely — the
depth is a static compile-time knob shared by every lane), the new direction's
norm collapses to ~eps·‖A·P⁻¹v‖ instead of exactly 0 under compiled FMA
reordering, and without a guard the back substitution divides two O(eps)
numbers — injecting O(1) garbage into an otherwise-exact solution (debugged:
the continuous-adjoint backward sweep diverged at gmres_iters=10 on a D=2
system while eager replays of the same math converged). A RELATIVE breakdown
test zeroes the basis vector and subdiagonal from that column on, per lane.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax.numpy as jnp
from jax import lax

# f32 einsums must not run at reduced precision (TF32 on the GPU)
_EINSUM_PRECISION = lax.Precision.HIGHEST


def gmres_batched(matvec: Callable, b, precond: Optional[Callable] = None,
                  iters: int = 20):
    """Solve A x = b per batch lane with right-preconditioned GMRES(k).

    matvec : v [M, N] -> A·v [M, N]   (each lane's independent operator)
    b      : [M, N]
    precond: optional v -> P⁻¹·v      (right preconditioning: A·P⁻¹ u = b)
    iters  : k, the (static) Arnoldi depth — there is no restart; pick k
             large enough for the preconditioned spectrum.

    Returns (x [M, N], resnorm [M]) where resnorm is the Givens residual
    estimate ‖b − A·x‖₂ per lane.
    """
    pc = precond if precond is not None else (lambda v: v)
    dtype = b.dtype

    def nrm(v):
        return jnp.sqrt(jnp.sum(v * v, axis=-1))

    def safe(x):
        return jnp.where(x == 0.0, jnp.ones_like(x), x)

    beta = nrm(b)                                    # [M]
    v_basis = [b / safe(beta)[:, None]]
    r_cols = []                                      # R's upper columns
    cs, sn = [], []
    g = []                                           # rotated rhs entries
    colnorm = []                                     # [M] Hessenberg col scale
    gj = beta
    eps = jnp.finfo(dtype).eps
    for j in range(iters):
        w = matvec(pc(v_basis[j]))
        wn0 = nrm(w)                                 # pre-MGS column scale
        # modified Gram–Schmidt
        hcol = []
        for i in range(j + 1):
            hij = jnp.sum(w * v_basis[i], axis=-1)
            hcol.append(hij)
            w = w - hij[:, None] * v_basis[i]
        hnext = nrm(w)
        # relative breakdown/exhaustion test (module docstring): a direction
        # that survived MGS at ~eps of its own scale is rounding noise, not a
        # Krylov vector — kill it and every later column for that lane
        ok_j = hnext > (64.0 * eps) * wn0
        hnext = jnp.where(ok_j, hnext, 0.0)
        v_basis.append(jnp.where(ok_j[:, None], w / safe(hnext)[:, None],
                                 0.0))
        # Hessenberg column scale for the rank test in back substitution
        colnorm.append(jnp.sqrt(sum(h * h for h in hcol) + hnext * hnext))
        # previous Givens rotations on the new column
        hc = list(hcol)
        for i in range(j):
            t1 = cs[i] * hc[i] + sn[i] * hc[i + 1]
            t2 = -sn[i] * hc[i] + cs[i] * hc[i + 1]
            hc[i], hc[i + 1] = t1, t2
        # new rotation eliminating the subdiagonal
        denom = jnp.sqrt(hc[j] ** 2 + hnext ** 2)
        c = jnp.where(denom == 0.0, jnp.ones_like(denom), hc[j] / safe(denom))
        s = jnp.where(denom == 0.0, jnp.zeros_like(denom),
                      hnext / safe(denom))
        cs.append(c)
        sn.append(s)
        hc[j] = c * hc[j] + s * hnext
        r_cols.append(hc)
        g.append(c * gj)
        gj = -s * gj
    # back substitution R y = g (R unit-free upper triangular, [M] entries).
    # Rank test per column: a pivot at noise level relative to its own
    # Hessenberg column (linearly dependent direction — breakdown or
    # exhaustion) gets y pinned to 0, the minimal-norm LS choice; a healthy
    # pivot on a breakdown column (e.g. A = I: h₀₀ = 1, hnext = 0) is kept
    y = [jnp.zeros_like(beta)] * iters
    for j in reversed(range(iters)):
        acc = g[j]
        for i in range(j + 1, iters):
            acc = acc - r_cols[i][j] * y[i]
        rjj = r_cols[j][j]
        rank_ok = jnp.abs(rjj) > (64.0 * eps) * colnorm[j]
        y[j] = jnp.where(rank_ok, acc / safe(rjj), 0.0)
    u = sum(y[j][:, None] * v_basis[j] for j in range(iters))
    x = pc(u)
    return x, jnp.abs(gj)


def _cdiv(ar, ai, br, bi):
    den = br * br + bi * bi
    den = jnp.where(den == 0.0, jnp.ones_like(den), den)
    return (ar * br + ai * bi) / den, (ai * br - ar * bi) / den


def tridiag_solve_complex(dl, d, du, b):
    """Batched complex Thomas sweep in split-real form.

    dl, d, du, b: pairs (re, im) of [..., N] arrays (dl[...,0], du[...,-1]
    ignored). Sequential in N via two lax.scan sweeps whose steps are
    [...]-vectorized (same shape as control.precond.tridiag_solve, lifted to
    complex arithmetic). No pivoting — preconditioner use.
    """
    dlr, dli = dl
    dr, di = d
    dur, dui = du
    br, bi = b
    batch = dr.shape[:-1]
    z = jnp.zeros(batch, dr.dtype)

    def fwd(carry, inp):
        cpr, cpi, dpr, dpi = carry
        a_r, a_i, m_r, m_i, u_r, u_i, f_r, f_i = inp
        # denom = d - dl*cp
        tr = m_r - (a_r * cpr - a_i * cpi)
        ti = m_i - (a_r * cpi + a_i * cpr)
        ncpr, ncpi = _cdiv(u_r, u_i, tr, ti)
        # dp = (b - dl*dp_prev) / denom
        sr = f_r - (a_r * dpr - a_i * dpi)
        si = f_i - (a_r * dpi + a_i * dpr)
        ndpr, ndpi = _cdiv(sr, si, tr, ti)
        return (ncpr, ncpi, ndpr, ndpi), (ncpr, ncpi, ndpr, ndpi)

    inp = tuple(jnp.moveaxis(a, -1, 0)
                for a in (dlr, dli, dr, di, dur, dui, br, bi))
    _, (cpr, cpi, dpr, dpi) = lax.scan(fwd, (z, z, z, z), inp)

    def bwd(carry, inp):
        xr, xi = carry
        c_r, c_i, p_r, p_i = inp
        nxr = p_r - (c_r * xr - c_i * xi)
        nxi = p_i - (c_r * xi + c_i * xr)
        return (nxr, nxi), (nxr, nxi)

    _, (xr, xi) = lax.scan(bwd, (z, z), (cpr, cpi, dpr, dpi), reverse=True)
    return jnp.moveaxis(xr, 0, -1), jnp.moveaxis(xi, 0, -1)


def tridiag_solve_pcr(dl, d, du, b):
    """Batched tridiagonal solve by PARALLEL CYCLIC REDUCTION.

    Same contract as ``control.precond.tridiag_solve`` (dl[..., 0] and
    du[..., -1] ignored; no pivoting — preconditioner use on diagonally
    dominant systems), but the elimination is ceil(log2 N) fully
    vectorized sweeps over the whole [..., N] array instead of two
    sequential length-N scans: each sweep eliminates the couplings at
    stride s (doubling s), leaving a diagonal system. The Thomas scans'
    critical path is 2N tiny [...]-wide steps; PCR's is ~12·log2 N
    elementwise ops on the full array (e.g. D=128: 256 scan steps → 7
    sweeps), at ~8× the FLOPs.
    """
    n = d.shape[-1]
    idx = jnp.arange(n)

    def safe(x):
        return jnp.where(x == 0.0, jnp.ones_like(x), x)

    a = jnp.where(idx == 0, 0.0, dl)
    c = jnp.where(idx == n - 1, 0.0, du)
    bb, dd = d, b
    s = 1
    while s < n:
        fill = lambda x, v: jnp.full(x.shape[:-1] + (s,), v, x.dtype)
        sl = lambda x, v: jnp.concatenate([x[..., s:], fill(x, v)], -1)
        sr = lambda x, v: jnp.concatenate([fill(x, v), x[..., :-s]], -1)
        am, bm, cm, dm = sr(a, 0.0), sr(bb, 1.0), sr(c, 0.0), sr(dd, 0.0)
        ap, bp, cp, dp_ = sl(a, 0.0), sl(bb, 1.0), sl(c, 0.0), sl(dd, 0.0)
        alpha = -a / safe(bm)                  # eliminate x_{i-s} via row i-s
        gamma = -c / safe(bp)                  # eliminate x_{i+s} via row i+s
        bb = bb + alpha * cm + gamma * ap
        dd = dd + alpha * dm + gamma * dp_
        a = alpha * am
        c = gamma * cp
        s *= 2
    return dd / safe(bb)


def tridiag_solve_complex_pcr(dl, d, du, b):
    """Split-real complex twin of ``tridiag_solve_pcr`` (the complex
    Radau stage pairs); same contract as ``tridiag_solve_complex``."""
    ar, ai = dl
    br_, bi_ = d
    cr, ci = du
    fr, fi = b
    n = br_.shape[-1]
    idx = jnp.arange(n)
    ar = jnp.where(idx == 0, 0.0, ar)
    ai = jnp.where(idx == 0, 0.0, ai)
    cr = jnp.where(idx == n - 1, 0.0, cr)
    ci = jnp.where(idx == n - 1, 0.0, ci)

    def cmul(xr, xi, yr, yi):
        return xr * yr - xi * yi, xr * yi + xi * yr

    s = 1
    while s < n:
        fill = lambda x, v: jnp.full(x.shape[:-1] + (s,), v, x.dtype)
        sl = lambda x, v: jnp.concatenate([x[..., s:], fill(x, v)], -1)
        sr = lambda x, v: jnp.concatenate([fill(x, v), x[..., :-s]], -1)
        amr, ami = sr(ar, 0.0), sr(ai, 0.0)
        bmr, bmi = sr(br_, 1.0), sr(bi_, 0.0)
        cmr, cmi = sr(cr, 0.0), sr(ci, 0.0)
        dmr, dmi = sr(fr, 0.0), sr(fi, 0.0)
        apr, api = sl(ar, 0.0), sl(ai, 0.0)
        bpr, bpi = sl(br_, 1.0), sl(bi_, 0.0)
        cpr, cpi = sl(cr, 0.0), sl(ci, 0.0)
        dpr, dpi = sl(fr, 0.0), sl(fi, 0.0)
        alr, ali = _cdiv(-ar, -ai, bmr, bmi)
        gar, gai = _cdiv(-cr, -ci, bpr, bpi)
        t1r, t1i = cmul(alr, ali, cmr, cmi)
        t2r, t2i = cmul(gar, gai, apr, api)
        br_, bi_ = br_ + t1r + t2r, bi_ + t1i + t2i
        t1r, t1i = cmul(alr, ali, dmr, dmi)
        t2r, t2i = cmul(gar, gai, dpr, dpi)
        fr, fi = fr + t1r + t2r, fi + t1i + t2i
        ar, ai = cmul(alr, ali, amr, ami)
        cr, ci = cmul(gar, gai, cpr, cpi)
        s *= 2
    return _cdiv(fr, fi, br_, bi_)


def tridiag_solve_auto(dl, d, du, b):
    """Tridiagonal solve by the method ``config.tridiag_method()`` picks
    for the backend (Thomas scans or PCR sweeps). Same results either way;
    the choice is made at trace time."""
    from janus_tpu import config
    from janus_tpu.control.precond import tridiag_solve as _thomas
    if config.tridiag_method() == "thomas":
        return _thomas(dl, d, du, b)
    return tridiag_solve_pcr(dl, d, du, b)


def tridiag_solve_complex_auto(dl, d, du, b):
    """Split-real complex twin of ``tridiag_solve_auto``."""
    from janus_tpu import config
    if config.tridiag_method() == "thomas":
        return tridiag_solve_complex(dl, d, du, b)
    return tridiag_solve_complex_pcr(dl, d, du, b)


def tridiag_bands_of(mat):
    """(dl, d, du) bands of an explicit batched matrix [M, N, N] (dl[...,0]
    and du[...,-1] zero-padded) — the shared band-extraction convention for
    the tridiagonal preconditioners."""
    mb = mat.shape[0]
    z1 = jnp.zeros((mb, 1), mat.dtype)
    d_ = jnp.diagonal(mat, axis1=-2, axis2=-1)
    dl_ = jnp.concatenate(
        [z1, jnp.diagonal(mat, offset=-1, axis1=-2, axis2=-1)], axis=-1)
    du_ = jnp.concatenate(
        [jnp.diagonal(mat, offset=1, axis1=-2, axis2=-1), z1], axis=-1)
    return dl_, d_, du_


def gmres_dense_solve(mat, rhs, iters):
    """GMRES solve of an EXPLICIT batched matrix (mass / DAE blocks) with
    its own tridiagonal preconditioner — exact in one application for
    FEM-style tridiagonal blocks, and convergent for the
    diagonally-dominant blocks MOL discretizations produce. Large N never
    meets the trace-time-unrolled LU this way."""
    mb, n = rhs.shape
    mmb = mat if mat.ndim == 3 else jnp.broadcast_to(mat, (mb, n, n))
    mv = lambda v: jnp.einsum("mij,mj->mi", mmb, v,            # noqa: E731
                              precision=_EINSUM_PRECISION)
    dl_, d_, du_ = tridiag_bands_of(mmb)
    pc = lambda v: tridiag_solve_auto(dl_, d_, du_, v)         # noqa: E731
    return gmres_batched(mv, rhs, pc, iters)[0]
