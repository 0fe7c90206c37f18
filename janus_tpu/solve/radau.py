"""Batched lockstep Radau IIA with simplified Newton — the flagship stiff path.

Re-designs the reference's RadauTe/RadauTeD (src/cpp/radaute_impl.hpp:537-1341,
radauted_impl.hpp:620-2929 — ~5.5k lines of mask algebra) as one
``lax.while_loop`` whose body is a single step ATTEMPT for every active
trajectory:

- per-trajectory h, Newton convergence, accept/reject, Jacobian reuse and
  factorization reuse are [M] boolean lanes combined with ``jnp.where``;
- Jacobian evaluation and LU factorization are gated by ``lax.cond`` on
  ``any(lane needs it)`` so the whole batch skips the expensive work when no
  lane requests it (the reference's NeedNewJac/NeedNewQR flags,
  radaute_impl.hpp:600-704);
- the transformed Newton systems solve one real D×D and (s−1)/2 split-real
  complex 2D×2D systems per iteration with the factorization REUSED across
  iterations (janus-linear role — janus_tpu.linalg unrolled batched LU);
- controller: Gustafsson predictive factor + Hairer safety scaled by Newton
  effort, with the quot1/quot2 deadzone that keeps the step size (and hence the
  LU factors) unchanged when the predicted change is small
  (reference radaute.hpp:84-95 knobs).

Algorithmic structure follows Hairer/Wanner (Solving ODEs II, Sec. IV.8) in the
arrangement popularized by scipy's Radau; tables come from
janus_tpu.solve.radau_tables (derived, any s ∈ {1,3,5,7}).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

# f32 einsums must not run at reduced precision (TF32 on the GPU)
_EINSUM_PRECISION = jax.lax.Precision.HIGHEST

from janus_tpu import config
from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok
from janus_tpu.solve import common as cm
from janus_tpu.solve.events import (handle_events, init_event_state,
                                    normalize_events)
from janus_tpu.solve.options import Options
from janus_tpu.solve.radau_tables import radau_tableau
from janus_tpu.diag.record import init_dyn, record_step


def default_jacobian(f: Callable) -> Callable:
    """Batched ∂f/∂y via D forward-mode JVP columns of the BATCHED rhs —
    works for any args pytree, no per-sample closure needed."""

    def jac(t, y, args):
        dim = y.shape[-1]
        cols = []
        for j in range(dim):
            tang = jnp.zeros_like(y).at[..., j].set(1.0)
            _, col = jax.jvp(lambda yy: f(t, yy, args), (y,), (tang,))
            cols.append(col)
        return jnp.stack(cols, axis=-1)  # [M, D, D]

    return jac


@struct.dataclass
class _NewtonState:
    w: jnp.ndarray            # [M, s, D]
    z: jnp.ndarray            # [M, s, D]
    dw_norm_old: jnp.ndarray  # [M]
    rate: jnp.ndarray         # [M]
    k: jnp.ndarray            # scalar iteration counter
    running: jnp.ndarray      # [M]
    converged: jnp.ndarray    # [M]
    niter: jnp.ndarray        # [M] iterations actually taken
    nfev: jnp.ndarray         # [M] rhs evals consumed


@struct.dataclass
class _RadauState:
    t: jnp.ndarray
    y: jnp.ndarray
    yd: Any                   # [K, M, D] tangent state (0-size when unused)
    t_lo: jnp.ndarray         # [M] double-word remainders (compensated mode;
    y_lo: jnp.ndarray         # [M, D] zeros when Options.compensated is off)
    f0: jnp.ndarray
    h: jnp.ndarray            # signed current step size
    jac: jnp.ndarray          # [M, D, D] (gmres mode: [M, 3, D] tri bands)
    t_lin: jnp.ndarray        # [M] Jacobian linearization point (gmres
    y_lin: jnp.ndarray        # [M, D] matrix-free J·v rides jvp at this)
    lu_real: jnp.ndarray      # [M, D, D]
    piv_real: jnp.ndarray     # [M, D]
    lu_cplx: jnp.ndarray      # [M, P, 2D, 2D]
    piv_cplx: jnp.ndarray     # [M, P, 2D]
    qr_vs_r: jnp.ndarray      # QR-fallback factors (Options.qr_fallback;
    qr_r_r: jnp.ndarray       # [M, D, D], or [M, 0, 0] when the flag is off)
    qr_vs_c: jnp.ndarray      # [M, P, 2D, 2D] (or [M, 0, 0, 0])
    qr_r_c: jnp.ndarray
    use_qr: jnp.ndarray       # [M] lane solves its stage systems via QR
    h_fact: jnp.ndarray       # [M] signed h the factors were built with (0 = none)
    current_jac: jnp.ndarray  # [M] Jacobian is fresh at (t, y)
    need_jac: jnp.ndarray     # [M]
    # step-size controller memory (Gustafsson two-step predictive)
    h_old: jnp.ndarray        # [M] |h| of last accepted step (0 = none)
    err_old: jnp.ndarray      # [M] error norm of last accepted step (0 = none)
    rejected: jnp.ndarray     # [M] a rejection happened since last accept
    nsing: jnp.ndarray        # [M] consecutive singular/Newton-fail count
    # dense output / warm start (previous accepted step's collocation poly)
    q_poly: jnp.ndarray       # [M, s, D]  (coeffs of θ¹..θˢ)
    y_prev: jnp.ndarray       # [M, D]
    h_prev: jnp.ndarray       # [M] signed h of previous accepted step
    have_sol: jnp.ndarray     # [M]
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any
    out_sd: Any               # [K, M, T, D] dense tangent samples (0-d unused)
    ev: Any
    dyn: Any
    mesh: Any                 # accepted-step rings for the adjoint backward
    #                           pass ({} when _mesh_size == 0)
    q_acc: jnp.ndarray        # [M, Q] running-cost quadratures (scalar 0
    #                           when quad= is unused)
    qd_acc: jnp.ndarray       # [K, M, Q] IND tangents of the quadratures
    #                           (scalar 0 unless quad= AND tangents=)
    td: Any                   # [K, M] event-time tangents dt*_k (scalar 0
    #                           unless tangents= AND events=)


def _build_iter_matrices(tab, h, jac, mass=None):
    """(a_real [M,D,D], blocks list of [M,2D,2D]): the real and split-real
    complex stage iteration matrices γ_q/h·M − J (shared by the LU
    factorization and the QR fallback)."""
    dim = jac.shape[-1]
    eye = jnp.eye(dim, dtype=jac.dtype)
    mm = eye if mass is None else mass
    a_real = (float(tab.mu_real) / h)[..., None, None] * mm - jac
    blocks = []
    for p in range((tab.s - 1) // 2):
        mu = tab.mu_complex[p]
        mur, mui = float(mu.real), float(mu.imag)       # weak-typed scalars
        ar = (mur / h)[..., None, None] * mm - jac
        ai = (mui / h)[..., None, None] * mm            # Im(mu) < 0
        top = jnp.concatenate([ar, -ai], axis=-1)
        bot = jnp.concatenate([ai, ar], axis=-1)
        blocks.append(jnp.concatenate([top, bot], axis=-2))
    return a_real, blocks


def _pallas_lu_factor(a, pivot=False):
    """Pivot-free Pallas LU of [..., D, D] (Options.pallas_lu); the packed
    factors are those of ``lu_factor(pivot=False)``, with identity pivots."""
    from janus_tpu.ops.smalllu_pallas import lu_factor as kernel_factor
    d = a.shape[-1]
    piv = jnp.broadcast_to(jnp.arange(d, dtype=jnp.int32), a.shape[:-1])
    return kernel_factor(a), piv


def _factorize(tab, h, jac, mass=None, pivot=True, factor=None):
    """Build and factor the real and split-complex iteration matrices."""
    dim = jac.shape[-1]
    factor = lu_factor if factor is None else factor
    a_real, blocks = _build_iter_matrices(tab, h, jac, mass)
    lu_r, piv_r = factor(a_real, pivot=pivot)
    ok = lu_ok(lu_r)
    lus, pivs = [], []
    for block in blocks:
        lu_c, piv_c = factor(block, pivot=pivot)
        ok = ok & lu_ok(lu_c)
        lus.append(lu_c)
        pivs.append(piv_c)
    if lus:
        lu_c = jnp.stack(lus, axis=1)
        piv_c = jnp.stack(pivs, axis=1)
    else:
        lu_c = jnp.zeros(jac.shape[:-2] + (0, 2 * dim, 2 * dim), jac.dtype)
        piv_c = jnp.zeros(jac.shape[:-2] + (0, 2 * dim), jnp.int32)
    return lu_r, piv_r, lu_c, piv_c, ok


def _qr_reg_ok(r):
    """Per-lane regularity of a Householder R factor (the lu_ok twin)."""
    diag = jnp.abs(jnp.diagonal(r, axis1=-2, axis2=-1))
    scale = jnp.max(jnp.abs(r), axis=(-2, -1))
    tol = jnp.finfo(r.dtype).eps * r.shape[-1] * 32.0
    return jnp.all(jnp.isfinite(r), axis=(-2, -1)) & \
        (jnp.min(diag, axis=-1) > tol * jnp.maximum(scale, 1e-30))


def _qr_factor_all(tab, h, jac, mass=None):
    """Householder QR of every stage iteration matrix — the per-lane
    fallback when the LU breaks (Options.qr_fallback; the reference keeps
    LU and QR side by side, radaute_impl.hpp:1558-1573). Returns
    (vs_r, r_r [M,D,D], vs_c, r_c [M,P,2D,2D], ok [M])."""
    from janus_tpu.linalg.qr import qr_factor
    a_real, blocks = _build_iter_matrices(tab, h, jac, mass)
    vs_r, r_r = qr_factor(a_real)
    ok = _qr_reg_ok(r_r)
    vs_cs, r_cs = [], []
    for block in blocks:
        vs_c, r_c = qr_factor(block)
        ok = ok & _qr_reg_ok(r_c)
        vs_cs.append(vs_c)
        r_cs.append(r_c)
    dim = jac.shape[-1]
    if vs_cs:
        vs_c = jnp.stack(vs_cs, axis=1)
        r_c = jnp.stack(r_cs, axis=1)
    else:
        vs_c = jnp.zeros(jac.shape[:-2] + (0, 2 * dim, 2 * dim), jac.dtype)
        r_c = vs_c
    return vs_r, r_r, vs_c, r_c, ok


def _newton(tab, f, t, y, h, z0, scale, tol, lu_r, piv_r, lu_c, piv_c,
            run_mask, max_iter, args, mass=None, solver=None):
    """Batched simplified Newton on the transformed collocation system.
    With a mass matrix M the collocation system is M·Z = h·A·F (DAE form,
    reference NbrInd1-3 support radaute.hpp:52-96): residuals use M·w.

    solver: optional (solve_real, solve_cplx) closures replacing the dense
    LU back-substitutions — solve_real(b[M,D]) and solve_cplx(p, b[M,2D])
    solve the real / p-th split-complex transformed stage system (the
    GMRES stage-solver path; reference decom_rc_gmres role)."""
    if solver is None:
        solve_real = lambda b: lu_solve(lu_r, piv_r, b)          # noqa: E731
        solve_cplx = lambda p, b: lu_solve(lu_c[:, p], piv_c[:, p], b)  # noqa: E731
    else:
        solve_real, solve_cplx = solver

    def mdot(w):
        if mass is None:
            return w
        return jnp.einsum("...ij,m...j->m...i", mass, w,
                          precision=_EINSUM_PRECISION) \
            if mass.ndim == 2 else jnp.einsum(
                "mij,mj->mi", mass, w, precision=_EINSUM_PRECISION)
    m, dim = y.shape
    dtype = y.dtype
    s = tab.s
    t_mat = jnp.asarray(tab.t_mat, dtype)
    ti_mat = jnp.asarray(tab.ti_mat, dtype)
    c_nodes = jnp.asarray(tab.c, dtype)
    npair = (s - 1) // 2

    # attainable-correction floor: stage values ride on y's ulp grid, so the
    # scaled Newton norm cannot drop below ~eps·|y|/scale. Lanes whose true
    # contraction is moderate reach this floor with measured rate ≈ 1
    # (successive corrections are rounding noise) and would loop until the
    # divergence test kills them — observed at f32 rtol 1e-6 on
    # heterogeneous-μ VdP sweeps (~1% of lanes NEWTON_STALL). At the floor
    # the iterate is the best this arithmetic can represent: converged.
    # Inactive in f64 (floor ≈ 1e-10·tol).
    eps_n = jnp.finfo(dtype).eps
    floor_tol = 2.0 * eps_n * cm.safe_sqrt(jnp.mean(
        jnp.square(jnp.abs(y) / scale), axis=-1))

    w0 = jnp.einsum("ij,mjd->mid", ti_mat, z0, precision=_EINSUM_PRECISION)
    init = _NewtonState(
        w=w0, z=z0,
        dw_norm_old=jnp.zeros((m,), dtype),
        rate=jnp.zeros((m,), dtype),
        k=jnp.zeros((), jnp.int32),
        running=run_mask, converged=jnp.zeros((m,), bool),
        niter=jnp.zeros((m,), jnp.int32),
        nfev=jnp.zeros((m,), jnp.int32),
    )

    def cond(ns):
        return jnp.any(ns.running)

    def body(ns):
        # stage RHS evaluations, one f call per stage
        fs = []
        for i in range(s):
            fs.append(f(t + c_nodes[i] * h, y + ns.z[:, i, :], args))
        fmat = jnp.stack(fs, axis=1)                    # [M, s, D]
        finite = jnp.all(jnp.isfinite(fmat), axis=(1, 2))
        fail_nan = ns.running & ~finite

        # transformed residuals and solves
        tif = jnp.einsum("ij,mjd->mid", ti_mat, fmat, precision=_EINSUM_PRECISION)   # [M, s, D]
        rhs_r = tif[:, 0, :] - (float(tab.mu_real) / h)[:, None] * mdot(ns.w[:, 0, :])
        dw_r = solve_real(rhs_r)
        dws = [dw_r]
        for p in range(npair):
            mu = tab.mu_complex[p]
            mur, mui = float(mu.real), float(mu.imag)
            w1 = mdot(ns.w[:, 1 + 2 * p, :])
            w2 = mdot(ns.w[:, 2 + 2 * p, :])
            # mu·(w1 + i·w2): real = Re·w1 − Im·w2, imag = Re·w2 + Im·w1
            fr = tif[:, 1 + 2 * p, :] - (mur * w1 - mui * w2) / h[:, None]
            fi = tif[:, 2 + 2 * p, :] - (mur * w2 + mui * w1) / h[:, None]
            sol = solve_cplx(p, jnp.concatenate([fr, fi], axis=-1))
            dws.append(sol[:, :dim])
            dws.append(sol[:, dim:])
        dw = jnp.stack(dws, axis=1)                     # [M, s, D]

        dw_norm = cm.safe_sqrt(jnp.mean(
            jnp.square(dw / scale[:, None, :]), axis=(1, 2)))
        have_rate = ns.k > 0
        rate = jnp.where(have_rate & (ns.dw_norm_old > 0),
                         dw_norm / jnp.where(ns.dw_norm_old == 0, 1.0,
                                             ns.dw_norm_old),
                         jnp.zeros_like(dw_norm))
        # divergence / hopeless-convergence tests (Hairer Θ logic; cf.
        # reference simplified_newton.py:113-135)
        steps_left = (max_iter - ns.k).astype(dtype)
        safe_rate = jnp.clip(rate, 1e-16, 1.0 - 1e-16)
        at_floor = dw_norm <= floor_tol
        diverged = have_rate & ~at_floor & (
            (rate >= 1.0)
            | (safe_rate ** steps_left / (1.0 - safe_rate) * dw_norm > tol))
        fail_now = ns.running & (fail_nan | diverged)

        apply = ns.running & ~fail_now
        w_new = jnp.where(apply[:, None, None], ns.w + dw, ns.w)
        z_new = jnp.einsum("ij,mjd->mid", t_mat, w_new, precision=_EINSUM_PRECISION)
        z_new = jnp.where(apply[:, None, None], z_new, ns.z)

        conv_now = apply & (
            (dw_norm == 0.0)
            | at_floor
            | (have_rate & (rate < 1.0)
               & (safe_rate / (1.0 - safe_rate) * dw_norm < tol)))

        k1 = ns.k + 1
        niter = jnp.where(ns.running, k1, ns.niter)
        running = ns.running & ~fail_now & ~conv_now & (k1 < max_iter)
        return _NewtonState(
            w=w_new, z=z_new,
            dw_norm_old=jnp.where(apply, dw_norm, ns.dw_norm_old),
            rate=jnp.where(ns.running, rate, ns.rate),
            k=k1,
            running=running,
            converged=ns.converged | conv_now,
            niter=niter,
            nfev=ns.nfev + ns.running * s,
        )

    out = jax.lax.while_loop(cond, body, init)
    return out


def _tangent_stages(tab, f, t, y, h, z, yd, tol, lu_r, piv_r,
                    lu_c, piv_c, mask, args, mass=None, max_iter=7,
                    args_d=None, gmres_solver=None):
    """Internal differentiation (Bock's IND; the reference's RadauTeD /
    solve_LUdual role, radauted_impl.hpp:1901-1936): tangent collocation
    stages for K seed directions through ONE accepted primal step, reusing
    the step's LU factors.

    The tangent system Zd_i = h Σ_j a_ij·J_j·(yd + Zd_j) is LINEAR; it is
    solved by the same transformed simplified iteration as the primal
    Newton (matrices already factored), converging at the primal's
    contraction rate. f is linearized ONCE per stage (s jvp closures); each
    iteration then costs s·K linear-map applications + K transformed
    back-substitutions — no fresh factorizations, no extra f evaluations.
    """
    k_dirs, m, dim = yd.shape
    s = tab.s
    dtype = y.dtype
    t_mat = jnp.asarray(tab.t_mat, dtype)
    ti_mat = jnp.asarray(tab.ti_mat, dtype)
    c_nodes = jnp.asarray(tab.c, dtype)
    npair = (s - 1) // 2

    def mdot(w):                                 # w: [K, M, s, D]
        if mass is None:
            return w
        eq = "ij,kmsj->kmsi" if mass.ndim == 2 else "mij,kmsj->kmsi"
        return jnp.einsum(eq, mass, w, precision=_EINSUM_PRECISION)

    # linearize the rhs at each converged stage point (one f eval each);
    # with parameter tangents (args_d, leading axis K) linearize jointly in
    # (y, args) so the forcing ∂f/∂θ·dθ enters every stage residual
    lins = []
    for i in range(s):
        ti = t + c_nodes[i] * h
        yi = y + z[:, i, :]
        if args_d is None:
            _, lin = jax.linearize(lambda yy: f(ti, yy, args), yi)
            lins.append(lambda dy, _k, _lin=lin: _lin(dy))
        else:
            _, lin = jax.linearize(lambda yy, aa: f(ti, yy, aa), yi, args)
            lins.append(lambda dy, da, _lin=lin: _lin(dy, da))

    if args_d is None:
        args_d_rows = [None] * k_dirs
    else:
        args_d_rows = [jax.tree_util.tree_map(lambda a: a[k], args_d)
                       for k in range(k_dirs)]

    def apply_lin(i, dys):                  # dys [K, M, D] -> [K, M, D]
        if args_d is None:
            return jax.vmap(lambda dy: lins[i](dy, None))(dys)
        return jnp.stack([lins[i](dys[k], args_d_rows[k])
                          for k in range(k_dirs)])

    if gmres_solver is None:
        def solve_k(rhs):                   # [K, M, D] -> [K, M, D]
            return jax.vmap(lambda b: lu_solve(lu_r, piv_r, b))(rhs)

        def solve_kc(p, rhs):               # complex pair p
            return jax.vmap(lambda b: lu_solve(lu_c[:, p], piv_c[:, p],
                                               b))(rhs)
    else:
        # stage_solver='gmres': the tangent systems reuse the step's SAME
        # frozen matrix-free solvers (they are preconditioners for the
        # converging transformed iteration, exactly as on the LU path) —
        # K solves per stage group, K static
        solve_real, solve_cplx = gmres_solver

        def solve_k(rhs):
            return jnp.stack([solve_real(rhs[k])
                              for k in range(rhs.shape[0])])

        def solve_kc(p, rhs):
            return jnp.stack([solve_cplx(p, rhs[k])
                              for k in range(rhs.shape[0])])

    init = (jnp.zeros((k_dirs, m, s, dim), dtype),   # wd (transformed)
            jnp.zeros((k_dirs, m, s, dim), dtype),   # zd
            jnp.zeros((), jnp.int32),
            jnp.ones((), bool))

    def cond_t(st):
        return st[3] & (st[2] < max_iter)

    def body_t(st):
        wd, zd, k, _ = st
        fd = jnp.stack([apply_lin(i, yd + zd[:, :, i, :])
                        for i in range(s)], axis=2)          # [K, M, s, D]
        tif = jnp.einsum("ij,kmjd->kmid", ti_mat, fd,
                         precision=_EINSUM_PRECISION)
        mw = mdot(wd)
        rhs_r = tif[:, :, 0] - (float(tab.mu_real) / h)[None, :, None] \
            * mw[:, :, 0]
        dws = [solve_k(rhs_r)]
        for p in range(npair):
            mu = tab.mu_complex[p]
            mur, mui = float(mu.real), float(mu.imag)
            w1 = mw[:, :, 1 + 2 * p]
            w2 = mw[:, :, 2 + 2 * p]
            fr = tif[:, :, 1 + 2 * p] - (mur * w1 - mui * w2) / h[None, :, None]
            fi = tif[:, :, 2 + 2 * p] - (mur * w2 + mui * w1) / h[None, :, None]
            sol = solve_kc(p, jnp.concatenate([fr, fi], axis=-1))
            dws.append(sol[..., :dim])
            dws.append(sol[..., dim:])
        dw = jnp.stack(dws, axis=2)                          # [K, M, s, D]
        wd_new = wd + dw
        zd_new = jnp.einsum("ij,kmjd->kmid", t_mat, wd_new,
                            precision=_EINSUM_PRECISION)
        # converge RELATIVE to the tangent magnitude (primal error scales
        # don't apply: sensitivities can be orders larger than y)
        scale_d = 1.0 + jnp.abs(yd)[:, :, None, :]           # [K, M, 1, D]
        dn = cm.safe_sqrt(jnp.mean(jnp.square(dw / scale_d), axis=(0, 2, 3)))
        keep_going = jnp.any(mask & (dn > tol) & jnp.isfinite(dn))
        return (wd_new, zd_new, k + 1, keep_going)

    _, zd, _, _ = jax.lax.while_loop(cond_t, body_t, init)
    return zd


def _gmres_mass_ops(mass, m, dim, like):
    """(mdotv, dl, d, du) for the mass term of the GMRES stage operator."""
    if mass is None:
        return (lambda v: v, jnp.zeros_like(like), jnp.ones_like(like),
                jnp.zeros_like(like))
    mm = mass if mass.ndim == 3 else jnp.broadcast_to(mass, (m, dim, dim))
    mdotv = lambda v: jnp.einsum("mij,mj->mi", mm, v,          # noqa: E731
                                 precision=_EINSUM_PRECISION)
    z1 = jnp.zeros((m, 1), mm.dtype)
    m_d = jnp.diagonal(mm, axis1=-2, axis2=-1)
    m_dl = jnp.concatenate(
        [z1, jnp.diagonal(mm, offset=-1, axis1=-2, axis2=-1)], axis=-1)
    m_du = jnp.concatenate(
        [jnp.diagonal(mm, offset=1, axis1=-2, axis2=-1), z1], axis=-1)
    return mdotv, m_dl, m_d, m_du


def _gmres_core(tab, jv, bands, h, mass_ops, iters):
    """Batched GMRES solvers for the transformed stage systems γ_q/h·M − J.

    jv applies J·v matrix-free; bands [M, 3, D] are J's tridiagonal
    (dl, d, du) for the tridiagonal preconditioner; mass_ops is
    ``_gmres_mass_ops`` output. Shared by the forward stage solves and the
    continuous-adjoint backward solves (there J := −Jᵀ, M := Mᵀ, h := h_b).

    iters == 0 (stage_solver='tridiag'): skip GMRES entirely and DIRECT-
    solve the tridiagonal part of the stage operator — a modified-Newton
    iteration matrix, exact for 3-point-stencil (1-D MOL) Jacobians and
    otherwise merely weaker: the surrounding simplified-Newton convergence
    monitor polices contraction exactly as it does for stale Jacobians, so
    a poor match slows or fails loudly, never silently corrupts.
    """
    # preconditioner sweeps by config.tridiag_method(): PCR (log-depth
    # parallel cyclic reduction) on the GPU, Thomas scans on the CPU
    from janus_tpu.linalg.gmres import (gmres_batched, tridiag_solve_auto
                                        as tridiag_solve,
                                        tridiag_solve_complex_auto
                                        as tridiag_solve_complex)

    dim = bands.shape[-1]
    j_dl, j_d, j_du = bands[:, 0], bands[:, 1], bands[:, 2]
    mdotv, m_dl, m_d, m_du = mass_ops
    gam = float(tab.mu_real) / h                               # [M]

    def solve_real(b):
        mv = lambda v: gam[:, None] * mdotv(v) - jv(v)         # noqa: E731
        a_dl = gam[:, None] * m_dl - j_dl
        a_d = gam[:, None] * m_d - j_d
        a_du = gam[:, None] * m_du - j_du
        ok = jnp.all(jnp.isfinite(a_d) & (a_d != 0.0), axis=-1,
                     keepdims=True)
        pc_d = jnp.where(ok, a_d, 1.0)
        pc_dl = jnp.where(ok, a_dl, 0.0)
        pc_du = jnp.where(ok, a_du, 0.0)
        pc = lambda v: tridiag_solve(pc_dl, pc_d, pc_du, v)    # noqa: E731
        if iters == 0:
            return pc(b)
        x, _ = gmres_batched(mv, b, pc, iters)
        return x

    def solve_cplx(p, b2):
        mu = tab.mu_complex[p]
        gr = float(mu.real) / h                                # [M]
        gi = float(mu.imag) / h

        def mv(v):
            vr, vi = v[:, :dim], v[:, dim:]
            mvr, mvi = mdotv(vr), mdotv(vi)
            outr = gr[:, None] * mvr - gi[:, None] * mvi - jv(vr)
            outi = gr[:, None] * mvi + gi[:, None] * mvr - jv(vi)
            return jnp.concatenate([outr, outi], axis=-1)

        a_dlr = gr[:, None] * m_dl - j_dl
        a_dli = gi[:, None] * m_dl
        a_dr = gr[:, None] * m_d - j_d
        a_di = gi[:, None] * m_d
        a_dur = gr[:, None] * m_du - j_du
        a_dui = gi[:, None] * m_du

        def pc(v):
            xr, xi = tridiag_solve_complex(
                (a_dlr, a_dli), (a_dr, a_di), (a_dur, a_dui),
                (v[:, :dim], v[:, dim:]))
            return jnp.concatenate([xr, xi], axis=-1)

        if iters == 0:
            return pc(b2)
        x, _ = gmres_batched(mv, b2, pc, iters)
        return x

    return solve_real, solve_cplx


def _gmres_mass_blocks(mass, m, nb, b, dtype):
    """(mdotv, mblk [M, nb, b, b]) for the block-Jacobi stage preconditioner:
    the full-mass matvec for the GMRES operator plus the mass's DIAGONAL
    blocks for the preconditioner (off-block mass couplings are left to the
    Krylov iteration, like the off-band couplings of the tridiag path)."""
    eye = jnp.broadcast_to(jnp.eye(b, dtype=dtype), (m, nb, b, b))
    if mass is None:
        return (lambda v: v), eye
    dim = nb * b
    mm = mass if mass.ndim == 3 else jnp.broadcast_to(mass, (m, dim, dim))
    mdotv = lambda v: jnp.einsum("mij,mj->mi", mm, v,          # noqa: E731
                                 precision=_EINSUM_PRECISION)
    mblk = jnp.moveaxis(
        jnp.diagonal(mm.reshape(m, nb, b, nb, b), axis1=1, axis2=3), -1, 1)
    return mdotv, mblk


def _guarded_block_lu(a):
    """Batched LU of preconditioner blocks with identity fallback on
    singular/non-finite blocks (preconditioning must never inject NaN —
    the Newton/GMRES layers police a weak preconditioner loudly)."""
    lu, piv = lu_factor(a, pivot=True)
    diag = jnp.abs(jnp.diagonal(lu, axis1=-2, axis2=-1))
    bad = (jnp.min(diag, axis=-1) <= 0.0) | \
        ~jnp.all(jnp.isfinite(lu), axis=(-2, -1))
    eye = jnp.broadcast_to(jnp.eye(a.shape[-1], dtype=a.dtype), lu.shape)
    lu = jnp.where(bad[..., None, None], eye, lu)
    piv = jnp.where(bad[..., None],
                    jnp.arange(a.shape[-1], dtype=piv.dtype), piv)
    return lu, piv


def _gmres_block_core(tab, jv, blocks, h, mdotv, mblk, iters):
    """Block-Jacobi twin of ``_gmres_core``: the preconditioner is the
    DIAGONAL-BLOCK part of the stage operator γ_q/h·M − J, factored once per
    step with the batched unrolled LU ([M, nb, b, b]; complex pairs via the
    2b×2b real embedding [[Ar, −Ai], [Ai, Ar]]). Exact for block-diagonal
    Jacobians (cell-local reaction terms); the Krylov iteration carries the
    cross-block (spatial) couplings. iters == 0 direct-solves the blocks
    (block modified Newton)."""
    from janus_tpu.linalg.gmres import gmres_batched

    m, nb, b, _ = blocks.shape
    dim = nb * b
    gam = float(tab.mu_real) / h                               # [M]

    a_r = gam[:, None, None, None] * mblk - blocks
    lu_r, piv_r = _guarded_block_lu(a_r)

    def solve_real(rhs):
        mv = lambda v: gam[:, None] * mdotv(v) - jv(v)         # noqa: E731
        pc = lambda v: lu_solve(                               # noqa: E731
            lu_r, piv_r, v.reshape(m, nb, b)).reshape(m, dim)
        if iters == 0:
            return pc(rhs)
        return gmres_batched(mv, rhs, pc, iters)[0]

    lus_c, pivs_c = [], []
    for p in range(len(tab.mu_complex)):
        mu = tab.mu_complex[p]
        gr = float(mu.real) / h
        gi = float(mu.imag) / h
        ar = gr[:, None, None, None] * mblk - blocks
        ai = gi[:, None, None, None] * mblk
        big = jnp.concatenate(
            [jnp.concatenate([ar, -ai], axis=-1),
             jnp.concatenate([ai, ar], axis=-1)], axis=-2)     # [M,nb,2b,2b]
        lu_c, piv_c = _guarded_block_lu(big)
        lus_c.append(lu_c)
        pivs_c.append(piv_c)

    def solve_cplx(p, b2):
        mu = tab.mu_complex[p]
        gr = float(mu.real) / h
        gi = float(mu.imag) / h

        def mv(v):
            vr, vi = v[:, :dim], v[:, dim:]
            mvr, mvi = mdotv(vr), mdotv(vi)
            outr = gr[:, None] * mvr - gi[:, None] * mvi - jv(vr)
            outi = gr[:, None] * mvi + gi[:, None] * mvr - jv(vi)
            return jnp.concatenate([outr, outi], axis=-1)

        def pc(v):
            vr = v[:, :dim].reshape(m, nb, b)
            vi = v[:, dim:].reshape(m, nb, b)
            out = lu_solve(lus_c[p], pivs_c[p],
                           jnp.concatenate([vr, vi], axis=-1))
            return jnp.concatenate([out[..., :b].reshape(m, dim),
                                    out[..., b:].reshape(m, dim)], axis=-1)

        if iters == 0:
            return pc(b2)
        return gmres_batched(mv, b2, pc, iters)[0]

    return solve_real, solve_cplx


def precond_probe_fn(f, precond, block, dim):
    """jac_fn(t, y, args) -> probed preconditioner data for the matrix-free
    stage path, dispatched on Options(precond=): [M, 3, D] bands for
    'tridiag'/'lines', [M, nb, b, b] diagonal blocks for 'block'. Shared by
    every solver family with matrix-free stage solves (radau, ndf)."""
    from janus_tpu.control.precond import (blocks_of_jacobian,
                                           line_tridiag_bands, tridiag_bands)
    if precond not in ("tridiag", "lines", "block"):
        raise ValueError(f"unknown precond {precond!r}")
    if precond in ("lines", "block"):
        if block <= 0 or dim % block != 0:
            raise ValueError(
                f"precond={precond!r} needs precond_block > 0 "
                f"dividing D={dim}, got {block}")
    if precond == "tridiag":
        def jac_fn(t, y, a):     # [M, 3, D] tridiagonal preconditioner bands
            dl, d, du = tridiag_bands(lambda yy: f(t, yy, a), y)
            return jnp.stack([dl, d, du], axis=1)
    elif precond == "lines":
        def jac_fn(t, y, a):     # [M, 3, D] in-line bands (2-D MOL rows)
            dl, d, du = line_tridiag_bands(lambda yy: f(t, yy, a), y, block)
            return jnp.stack([dl, d, du], axis=1)
    else:
        def jac_fn(t, y, a):     # [M, nb, b, b] diagonal blocks
            return blocks_of_jacobian(lambda yy: f(t, yy, a), y, block)
    return jac_fn


def gmres_shifted_solver(f, t_lin, y_lin, args, pdata, a_coef, b_coef, mass,
                         iters, precond="tridiag", block=0):
    """solve(rhs) for the REAL shifted system (a·M − b·J)·x = rhs,
    matrix-free (J·v by jvp at the frozen linearization point), with the
    probed structure preconditioner selected by ``precond``. a_coef/b_coef
    are per-lane [M] scalars. The BDF/NDF corrector role (reference
    vdp_bdf_gmres.cpp, odesolvers/linsolve.py:60-111 serving
    CommonIntegrator's bdf2 mode); iters == 0 direct-solves the
    preconditioner structure (modified Newton)."""
    from janus_tpu.linalg.gmres import (gmres_batched, tridiag_solve_auto)

    m, dim = y_lin.shape
    dtype = y_lin.dtype

    def jv(v):
        return jax.jvp(lambda yy: f(t_lin, yy, args), (y_lin,), (v,))[1]

    if precond == "block":
        mdotv, mblk = _gmres_mass_blocks(mass, m, dim // block, block, dtype)
        a_blk = (a_coef[:, None, None, None] * mblk
                 - b_coef[:, None, None, None] * pdata)
        lu_b, piv_b = _guarded_block_lu(a_blk)
        pc = lambda v: lu_solve(                                # noqa: E731
            lu_b, piv_b, v.reshape(m, -1, block)).reshape(m, dim)
    else:
        mdotv, m_dl, m_d, m_du = _gmres_mass_ops(mass, m, dim, pdata[:, 1])
        a_dl = a_coef[:, None] * m_dl - b_coef[:, None] * pdata[:, 0]
        a_d = a_coef[:, None] * m_d - b_coef[:, None] * pdata[:, 1]
        a_du = a_coef[:, None] * m_du - b_coef[:, None] * pdata[:, 2]
        okp = jnp.all(jnp.isfinite(a_d) & (a_d != 0.0), axis=-1,
                      keepdims=True)
        pc_d = jnp.where(okp, a_d, 1.0)
        pc_dl = jnp.where(okp, a_dl, 0.0)
        pc_du = jnp.where(okp, a_du, 0.0)
        pc = lambda v: tridiag_solve_auto(pc_dl, pc_d, pc_du, v)  # noqa: E731

    def solve(rhs):
        mv = lambda v: a_coef[:, None] * mdotv(v) \
            - b_coef[:, None] * jv(v)                           # noqa: E731
        if iters == 0:
            return pc(rhs)
        return gmres_batched(mv, rhs, pc, iters)[0]

    return solve, mdotv


def gmres_shifted_solver_T(f, t_lin, y_lin, args, pdata, a_coef, b_coef,
                           mass, iters, precond="tridiag", block=0):
    """solve(rhs) for the TRANSPOSED real shifted system
    (a·M − b·J)ᵀ x = rhs, matrix-free: Jᵀ·v is a ``jax.vjp`` PULL of the
    rhs at the frozen linearization point (reverse mode is the natural
    direction for transposed operators — J is never materialized), Mᵀ·v an
    explicit matvec, and the preconditioner is the TRANSPOSE of the probed
    forward structure — bands: (Jᵀ)_dl[i] = J_du[i−1], (Jᵀ)_du[i] =
    J_dl[i+1] (line-boundary zeros map to line-boundary zeros, so 'lines'
    rides the same shift); blocks: per-block transpose. The discrete-
    adjoint twin of ``gmres_shifted_solver`` (the IFT corrector pulls of
    solve/adjoint_ndf.py); iters == 0 direct-solves the transposed
    preconditioner structure."""
    from janus_tpu.linalg.gmres import gmres_batched, tridiag_solve_auto

    m, dim = y_lin.shape
    dtype = y_lin.dtype
    pull = jax.vjp(lambda yy: f(t_lin, yy, args), y_lin)[1]

    def jtv(v):
        return pull(v)[0]

    mass_t = None if mass is None else jnp.swapaxes(
        mass if mass.ndim == 3 else jnp.broadcast_to(
            mass[None], (m, dim, dim)), -1, -2)

    if precond == "block":
        mdotv, mblk = _gmres_mass_blocks(mass_t, m, dim // block, block,
                                         dtype)
        a_blk = (a_coef[:, None, None, None] * mblk
                 - b_coef[:, None, None, None]
                 * jnp.swapaxes(pdata, -1, -2))
        lu_b, piv_b = _guarded_block_lu(a_blk)
        pc = lambda v: lu_solve(                                # noqa: E731
            lu_b, piv_b, v.reshape(m, -1, block)).reshape(m, dim)
    else:
        mdotv, m_dl, m_d, m_du = _gmres_mass_ops(mass_t, m, dim,
                                                 pdata[:, 1])
        z1 = jnp.zeros((m, 1), dtype)
        jt_dl = jnp.concatenate([z1, pdata[:, 2, :-1]], axis=1)
        jt_du = jnp.concatenate([pdata[:, 0, 1:], z1], axis=1)
        a_dl = a_coef[:, None] * m_dl - b_coef[:, None] * jt_dl
        a_d = a_coef[:, None] * m_d - b_coef[:, None] * pdata[:, 1]
        a_du = a_coef[:, None] * m_du - b_coef[:, None] * jt_du
        okp = jnp.all(jnp.isfinite(a_d) & (a_d != 0.0), axis=-1,
                      keepdims=True)
        pc_d = jnp.where(okp, a_d, 1.0)
        pc_dl = jnp.where(okp, a_dl, 0.0)
        pc_du = jnp.where(okp, a_du, 0.0)
        pc = lambda v: tridiag_solve_auto(pc_dl, pc_d, pc_du, v)  # noqa: E731

    def solve(rhs):
        mv = lambda v: a_coef[:, None] * mdotv(v) \
            - b_coef[:, None] * jtv(v)                          # noqa: E731
        if iters == 0:
            return pc(rhs)
        return gmres_batched(mv, rhs, pc, iters)[0]

    return solve


def _gmres_stage_solver(tab, f, t_lin, y_lin, args, pdata, h, mass, iters,
                        precond="tridiag", block=0):
    """Matrix-free transformed-stage solvers for stage_solver='gmres'.

    The reference's decom_rc_gmres role (odesolvers/linsolve.py:61-110): in
    place of dense LU factors of (γ/h·M − J), each stage system is solved by
    batched GMRES(k) whose operator applies J·v as a jvp of the rhs at the
    FROZEN linearization point (t_lin, y_lin) — J is never materialized —
    preconditioned by the structure selected in Options(precond=):
    (complex) tridiagonal Thomas/PCR sweeps from probed bands
    (pdata [M, 3, D]; 'tridiag' = plain 1-D, 'lines' = line-blocked 2-D MOL)
    or block-Jacobi LU solves from probed diagonal blocks
    (pdata [M, nb, b, b]; 'block').
    """
    m, dim = y_lin.shape

    def jv(v):
        return jax.jvp(lambda yy: f(t_lin, yy, args), (y_lin,), (v,))[1]

    if precond == "block":
        mdotv, mblk = _gmres_mass_blocks(mass, m, dim // block, block,
                                         y_lin.dtype)
        return _gmres_block_core(tab, jv, pdata, h, mdotv, mblk, iters)
    mass_ops = _gmres_mass_ops(mass, m, dim, pdata[:, 1])
    return _gmres_core(tab, jv, pdata, h, mass_ops, iters)


def solve_radau(f: Callable, t0, tf, y0, args=None,
                options: Optional[Options] = None, t_eval=None,
                jac: Optional[Callable] = None, mass=None,
                events=None, tangents=None,
                args_tangents=None, quad: Optional[Callable] = None,
                dense: int = 0, step_args=None, _mesh_size: int = 0,
                _h0=None) -> cm.Solution:
    """Batched adaptive Radau IIA solve (fixed stage count = options.min_stages).

    tangents: optional [K, M, D] seed directions for FIRST-CLASS forward
    sensitivities by internal differentiation (one primal solve + K linear
    tangent sweeps per accepted step reusing the step's LU factors — the
    reference's RadauTeD architecture, radauted_impl.hpp:620-2929, instead
    of K vmapped re-solves). Result in ``Solution.sens`` [K, M, D] =
    directional ∂y(T)/∂y0·seed_k along the SAME step sequence as the primal
    (Bock's IND). args_tangents: optional pytree matching ``args`` with a
    leading K axis — parameter seed directions dθ_k (the reference's dual
    params); combine with ``tangents`` (same K) or pass alone (y0 seeds
    zero).

    Tangents combine with t_eval (``Solution.sens_ys`` [K,M,T,D]: the
    tangent of the collocation interpolant, the reference's dual dense
    output ntrprad-on-TensorDual, radauted_impl.hpp:1714-1743) and with
    events: a lane terminated by an event returns the TOTAL derivative at
    the event, yd(t*) + f(t*,y*)·dt* with the implicit-function correction
    dt* = −(g_y·yd)/(g_t + g_y·f) (the reference's EventZeroFcn on dual
    trajectories, radauted_impl.hpp:2306).

    quad: optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
    (or ``[M, Q]`` for Q simultaneous functionals). ``Solution.quad``
    accumulates ∫ l dt over each lane's integration window at the step's
    own Radau quadrature (nodes c, weights b — order 2s−1, the solve's
    order; the CVODES quadrature-integration role, which the reference
    lacks). Event-terminated lanes integrate only to t* (the partial last
    step is quadratured on the collocation interpolant). With ``tangents=``
    the IND sweep also carries the quadrature tangents
    dq_k = ∫ l_y·yd_k + l_θ·dθ_k dt (+ l(t*)·dt*_k on event lanes) into
    ``Solution.sens_quad`` [K, M(, Q)] — the CVODES quadrature-sensitivity
    role. The quadrature never feeds back into step control or the state;
    for reverse-mode gradients of integral costs use
    ``radau_adjoint(cost=...)`` (solve.adjoint).

    dense: step-mesh capacity N > 0 stores every accepted step's collocation
    polynomial so ``Solution.interpolate(ts)`` can evaluate the solution
    ANYWHERE post hoc (scipy's dense_output/sol(t) role; the reference's
    on-demand ntrprad). Size N ≥ the worst lane's accepted-step count —
    overflowing lanes interpolate to NaN, never silently-wrong values.
    """
    opts = options if options is not None else Options()
    if dense:
        # public face of the adjoint's step-mesh rings: store every accepted
        # step's collocation polynomial for Solution.interpolate()
        _mesh_size = max(_mesh_size, int(dense))
    specs = normalize_events(events)
    use_sens = tangents is not None or args_tangents is not None
    if opts.stage_solver not in ("lu", "gmres", "tridiag"):
        raise ValueError(f"unknown stage_solver {opts.stage_solver!r}")
    use_gmres = opts.stage_solver != "lu"
    if use_gmres and jac is not None:
        raise ValueError("stage_solver='gmres' is matrix-free (J·v by jvp, "
                         "3-probe tridiagonal preconditioner); drop jac=")
    use_qr_fb = opts.qr_fallback and not use_gmres
    use_pallas = config.use_stage_lu_kernel(opts)
    if use_pallas and use_gmres:
        raise ValueError("Options(pallas_lu=True) is the LU stage solver; "
                         "it does not combine with stage_solver="
                         f"{opts.stage_solver!r}")
    if use_pallas and opts.qr_fallback:
        raise ValueError("pallas_lu and qr_fallback are mutually "
                         "exclusive (pick one stage-solve override)")
    s = opts.min_stages
    tab = radau_tableau(s)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    npair = (s - 1) // 2

    if use_gmres:
        jac_fn = precond_probe_fn(f, opts.precond, opts.precond_block, dim)
    else:
        jac_fn = jac if jac is not None else default_jacobian(f)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))
    max_iter = opts.newton_max_iter
    p_mat = jnp.asarray(tab.p, dtype)
    e_vec = jnp.asarray(tab.e, dtype)
    c_nodes = jnp.asarray(tab.c, dtype)

    # index-2/3 components get their error (and Newton) weights scaled by
    # h / h² (Hairer's higher-index DAE mechanism)
    ind_exp, use_index = cm.index_weights(opts, dim, dtype)

    use_slabs = step_args is not None
    if use_slabs:
        # per-ACCEPTED-step parameter slabs (the reference's adaptive-
        # stepper theta/nparams_step semantics, dopri853ted.hpp:302-308,
        # extended to the collocation family): a lane's k-th accepted-step
        # ATTEMPT evaluates every stage RHS, the Jacobian, and the error-
        # estimate f's with slab row k as f(t, y, (args, slab_k)); events
        # and quad integrands see plain args. The stale-Jacobian reuse
        # policy is unchanged — J is only an iteration matrix; the
        # converged stages are slab-row-exact because the Newton residual
        # evaluates f fresh under the row.
        if tangents is not None or args_tangents is not None:
            raise ValueError("step_args= does not compose with tangents= "
                             "(slab rows are step-indexed; seed the slab "
                             "leaves via jax.jvp instead)")
        if _mesh_size or dense:
            raise ValueError("step_args= does not compose with the "
                             "adjoint / dense= (the replay has no slab "
                             "index); use models.controls time-indexed "
                             "schedules for differentiable controls")
        n_slabs, slab_at = cm.make_slab_selector(step_args, m, dtype)

    args0 = (args, slab_at(jnp.zeros((m,), jnp.int32))) if use_slabs \
        else args
    f0 = f(t0, y0, args0)
    if _h0 is not None:
        # signed per-lane warm start (segment chaining in solve.adjoint);
        # lanes with _h0 == 0 fall back to the automatic initial step, and
        # the in-loop boundary clamp bounds the rest by |tf - t|
        direction = jnp.where(tf >= t0, 1.0, -1.0).astype(dtype)
        if mass is None:
            h_auto = cm.initial_step(f, t0, y0, f0, tf, s, opts.rtol,
                                     opts.atol, args0, opts.max_step)
        else:
            h_auto = jnp.minimum(1e-3, jnp.abs(tf - t0) * 1e-2) * direction
        h_mag = jnp.abs(jnp.broadcast_to(jnp.asarray(_h0, dtype), (m,)))
        h = jnp.where(h_mag > 0, h_mag * direction, h_auto)
    elif opts.h0 == 0.0:
        if mass is None:
            h = cm.initial_step(f, t0, y0, f0, tf, s, opts.rtol, opts.atol,
                                args0, opts.max_step)
        else:
            # Hairer's hinit treats f0 as a derivative, which is wrong for
            # the algebraic rows of a singular-mass system — start small and
            # let the controller grow (the reference ships fixed h0 in its
            # DAE examples)
            direction = jnp.where(tf >= t0, 1.0, -1.0).astype(dtype)
            h = jnp.minimum(1e-3, jnp.abs(tf - t0) * 1e-2) * direction
    else:
        direction = jnp.where(tf >= t0, 1.0, -1.0).astype(dtype)
        h = jnp.broadcast_to(jnp.asarray(opts.h0, dtype), (m,)) * direction

    use_dense = t_eval is not None
    if use_dense:
        t_eval = jnp.asarray(t_eval, dtype)
        at_t0 = (t_eval[None, :] == t0[:, None])
        out_ys = jnp.where(at_t0[..., None], y0[:, None, :], jnp.nan)
    else:
        out_ys = jnp.zeros((), dtype)

    use_quad = quad is not None
    if use_quad:
        b_vec = jnp.asarray(tab.b, dtype)
        qshape = jax.eval_shape(lambda: quad(t0, y0, args)).shape
        if qshape not in ((m,),) and (len(qshape) != 2 or qshape[0] != m):
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1
        qdim = 1 if quad_scalar else qshape[1]

        def _qla(t, y, aa):                  # args-open variant (jvp seat)
            return cm.canon_cost(quad(t, y, aa))

        def _ql(t, y):                       # canon [M, Q]
            return _qla(t, y, args)
        q_acc0 = jnp.zeros((m, qdim), dtype)
    else:
        q_acc0 = jnp.zeros((), dtype)        # unused: keep the loop state
        #                                      free of zero-width arrays

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "nnewton"))
    stats["nfev"] = stats["nfev"] + 2
    if use_sens:
        if args_tangents is not None:
            args_d = jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, dtype), args_tangents)
            k_args = jax.tree_util.tree_leaves(args_d)[0].shape[0]
        else:
            args_d, k_args = None, None
        if tangents is not None:
            yd0 = jnp.asarray(tangents, dtype)
            if yd0.ndim != 3 or yd0.shape[1:] != (m, dim):
                raise ValueError(f"tangents must be [K, {m}, {dim}], got "
                                 f"{yd0.shape}")
            if k_args is not None and k_args != yd0.shape[0]:
                raise ValueError(f"tangents K={yd0.shape[0]} != "
                                 f"args_tangents K={k_args}")
        else:
            yd0 = jnp.zeros((k_args, m, dim), dtype)
    else:
        yd0 = jnp.zeros((0, m, dim), dtype)
        args_d = None

    if use_sens and use_dense:
        out_sd = jnp.where(at_t0[None, :, :, None], yd0[:, :, None, :],
                           jnp.nan)
    else:
        out_sd = jnp.zeros((), dtype)

    if _mesh_size:
        # accepted-step rings for the continuous-adjoint backward pass
        # (solve.adjoint): step start t, signed h, start state, and the
        # dense-output polynomial coefficients of every accepted step
        mesh0 = {"t": jnp.zeros((m, _mesh_size), dtype),
                 "h": jnp.zeros((m, _mesh_size), dtype),
                 "y": jnp.zeros((m, _mesh_size, dim), dtype),
                 "q": jnp.zeros((m, _mesh_size, s, dim), dtype)}
    else:
        mesh0 = {}

    use_quad_sens = use_quad and use_sens
    qd_acc0 = jnp.zeros((yd0.shape[0], m, qdim), dtype) if use_quad_sens \
        else jnp.zeros((), dtype)

    already_done = t0 == tf
    state = _RadauState(
        t=t0, y=y0, yd=yd0,
        t_lo=jnp.zeros((m,), dtype), y_lo=jnp.zeros((m, dim), dtype),
        f0=f0, h=h,
        jac=jnp.zeros(
            (m, dim // opts.precond_block, opts.precond_block,
             opts.precond_block) if (use_gmres and opts.precond == "block")
            else (m, 3, dim) if use_gmres else (m, dim, dim), dtype),
        t_lin=t0, y_lin=y0,
        lu_real=jnp.zeros((m, 0, 0) if use_gmres else (m, dim, dim), dtype),
        piv_real=jnp.zeros((m, 0) if use_gmres else (m, dim), jnp.int32),
        lu_cplx=jnp.zeros((m, npair, 0, 0) if use_gmres
                          else (m, npair, 2 * dim, 2 * dim), dtype),
        piv_cplx=jnp.zeros((m, npair, 0) if use_gmres
                           else (m, npair, 2 * dim), jnp.int32),
        qr_vs_r=jnp.zeros((m, dim, dim) if use_qr_fb else (m, 0, 0), dtype),
        qr_r_r=jnp.zeros((m, dim, dim) if use_qr_fb else (m, 0, 0), dtype),
        qr_vs_c=jnp.zeros((m, npair, 2 * dim, 2 * dim) if use_qr_fb
                          else (m, 0, 0, 0), dtype),
        qr_r_c=jnp.zeros((m, npair, 2 * dim, 2 * dim) if use_qr_fb
                         else (m, 0, 0, 0), dtype),
        use_qr=jnp.zeros((m,), bool),
        h_fact=jnp.zeros((m,), dtype),
        current_jac=jnp.zeros((m,), bool),
        need_jac=jnp.ones((m,), bool),
        h_old=jnp.zeros((m,), dtype),
        err_old=jnp.zeros((m,), dtype),
        rejected=jnp.zeros((m,), bool),
        nsing=jnp.zeros((m,), jnp.int32),
        q_poly=jnp.zeros((m, s, dim), dtype),
        y_prev=y0,
        h_prev=jnp.ones((m,), dtype),
        have_sol=jnp.zeros((m,), bool),
        active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys, out_sd=out_sd,
        ev=init_event_state(specs, m, dim, t0, y0, args, dtype),
        dyn=init_dyn(m, opts.record_steps, dtype,
                     dim if opts.record_states else 0),
        mesh=mesh0,
        q_acc=q_acc0,
        qd_acc=qd_acc0,
        td=(jnp.zeros((yd0.shape[0], m), dtype)
            if (use_sens and specs) else jnp.zeros((), dtype)),
    )

    eps = jnp.finfo(dtype).eps

    def cond(st):
        return jnp.any(st.active)

    def body(st):
        # ---- step-size clamp to the boundary -----------------------------
        dir0 = jnp.sign(st.h)
        dir0 = jnp.where(dir0 == 0, 1.0, dir0)
        remaining = (tf - st.t) - st.t_lo
        # compensated t can overshoot tf by O(eps^2): force a final
        # forward-direction sliver instead of a sign-flipped (backward) step
        overshoot = remaining * dir0 <= 0.0
        remaining = jnp.where(overshoot,
                              dir0 * eps * jnp.maximum(jnp.abs(tf), 1.0),
                              remaining)
        last = jnp.abs(st.h) >= jnp.abs(remaining)
        h = jnp.where(last, remaining, st.h)
        h = jnp.where(h == 0.0, eps * dir0, h)

        if use_slabs:
            # a lane's k-th accepted-step attempt (all stage/Jacobian/
            # error-estimate f evals) runs on slab row k
            exhausted = st.active & (st.stats["naccept"] >= n_slabs)
            fa = (args, slab_at(st.stats["naccept"]))
        else:
            exhausted = jnp.zeros((m,), bool)
            fa = args

        # ---- Jacobian refresh (gated: skip when no lane needs it) --------
        needj = st.need_jac & st.active

        def do_jac(_):
            jnew = jac_fn(st.t, st.y, fa)
            sel = needj.reshape((m,) + (1,) * (jnew.ndim - 1))
            return jnp.where(sel, jnew, st.jac)

        with jax.named_scope("radau.jacobian"):
            jmat = jax.lax.cond(jnp.any(needj), do_jac, lambda _: st.jac,
                                operand=None)
        current_jac = st.current_jac | needj
        t_lin = jnp.where(needj, st.t, st.t_lin)
        y_lin = jnp.where(needj[:, None], st.y, st.y_lin)

        # ---- factorization (gated; gmres mode has nothing to factor) -----
        needf = st.active & (needj | (h != st.h_fact))

        if use_gmres:
            lu_r, piv_r = st.lu_real, st.piv_real
            lu_c, piv_c = st.lu_cplx, st.piv_cplx
            fact_ok = jnp.all(jnp.isfinite(jmat),
                              axis=tuple(range(1, jmat.ndim)))
            h_fact = jnp.where(needf, h, st.h_fact)
            solver = _gmres_stage_solver(
                tab, f, t_lin, y_lin, fa, jmat, h, mass,
                0 if opts.stage_solver == "tridiag" else opts.gmres_iters,
                precond=opts.precond, block=opts.precond_block)
        else:
            def do_fact(_):
                lr, pr, lc, pc, ok = _factorize(
                    tab, h, jmat, mass, opts.pivoting,
                    factor=_pallas_lu_factor if use_pallas else None)
                sel = needf
                return (
                    jnp.where(sel[:, None, None], lr, st.lu_real),
                    jnp.where(sel[:, None], pr, st.piv_real),
                    jnp.where(sel[:, None, None, None], lc, st.lu_cplx),
                    jnp.where(sel[:, None, None], pc, st.piv_cplx),
                    jnp.where(sel, ok, jnp.ones_like(ok)),
                    jnp.where(sel, h, st.h_fact),
                )

            def keep_fact(_):
                return (st.lu_real, st.piv_real, st.lu_cplx, st.piv_cplx,
                        jnp.ones((m,), bool), st.h_fact)

            with jax.named_scope("radau.factorize"):
                lu_r, piv_r, lu_c, piv_c, fact_ok, h_fact = jax.lax.cond(
                    jnp.any(needf), do_fact, keep_fact, operand=None)
            solver = None
            if use_pallas:
                from janus_tpu.ops import lu_solve as kernel_solve
                solver = (lambda b: kernel_solve(lu_r, b),
                          lambda p, b: kernel_solve(lu_c[:, p], b))

        qr_vs_r, qr_r_r = st.qr_vs_r, st.qr_r_r
        qr_vs_c, qr_r_c = st.qr_vs_c, st.qr_r_c
        use_qr = st.use_qr
        if opts.qr_fallback and not use_gmres:
            # per-lane QR rescue of broken LU factorizations (zero/tiny
            # pivots; reference keeps both decompositions alive,
            # radaute_impl.hpp:1558-1573). Cond-gated: zero cost until a
            # lane actually fails.
            lu_fail = needf & ~fact_ok

            def do_qr(_):
                vs_r, r_r, vs_c, r_c, qok = _qr_factor_all(tab, h, jmat,
                                                           mass)
                sel = lu_fail
                return (jnp.where(sel[:, None, None], vs_r, st.qr_vs_r),
                        jnp.where(sel[:, None, None], r_r, st.qr_r_r),
                        jnp.where(sel[:, None, None, None], vs_c,
                                  st.qr_vs_c),
                        jnp.where(sel[:, None, None, None], r_c,
                                  st.qr_r_c),
                        sel & qok)

            def keep_qr(_):
                return (st.qr_vs_r, st.qr_r_r, st.qr_vs_c, st.qr_r_c,
                        jnp.zeros((m,), bool))

            with jax.named_scope("radau.qr_fallback"):
                qr_vs_r, qr_r_r, qr_vs_c, qr_r_c, qr_new = jax.lax.cond(
                    jnp.any(lu_fail), do_qr, keep_qr, operand=None)
            # freshly-factored lanes switch solver per this factorization;
            # others keep whatever mode their live factors use
            use_qr = jnp.where(needf, qr_new, st.use_qr)
            fact_ok = fact_ok | qr_new

            from janus_tpu.linalg.qr import qr_solve

            def solve_real_h(b):
                base = lu_solve(lu_r, piv_r, b)
                return jax.lax.cond(
                    jnp.any(use_qr),
                    lambda _: jnp.where(use_qr[:, None],
                                        qr_solve(qr_vs_r, qr_r_r, b), base),
                    lambda _: base, operand=None)

            def solve_cplx_h(p, b):
                base = lu_solve(lu_c[:, p], piv_c[:, p], b)
                return jax.lax.cond(
                    jnp.any(use_qr),
                    lambda _: jnp.where(
                        use_qr[:, None],
                        qr_solve(qr_vs_c[:, p], qr_r_c[:, p], b), base),
                    lambda _: base, operand=None)

            solver = (solve_real_h, solve_cplx_h)

        singular = st.active & ~fact_ok

        # ---- Newton warm start from previous collocation polynomial ------
        theta_ws = 1.0 + c_nodes[None, :] * (h / st.h_prev)[:, None]  # [M,s]
        powers = jnp.stack([theta_ws ** (q + 1) for q in range(s)], axis=-1)
        poly_at = jnp.einsum("msq,mqd->msd", powers, st.q_poly, precision=_EINSUM_PRECISION)
        poly_at_1 = jnp.sum(st.q_poly, axis=1)          # poly(1) = Σ_q Q_q
        z0 = jnp.where(st.have_sol[:, None, None],
                       poly_at - poly_at_1[:, None, :],
                       jnp.zeros((m, s, dim), dtype))

        # ---- simplified Newton -------------------------------------------
        scale_n = opts.atol + opts.rtol * jnp.abs(st.y)
        if use_index:
            # weight index-2/3 components down by h^k in the norms
            hw = jnp.abs(h)[:, None] ** ind_exp[None, :]
            scale_n = scale_n / hw
        run_newton = st.active & fact_ok & ~exhausted
        with jax.named_scope("radau.newton"):
            ns = _newton(tab, f, st.t, st.y, h, z0, scale_n, newton_tol,
                         lu_r, piv_r, lu_c, piv_c, run_newton, max_iter,
                         fa, mass=mass, solver=solver)
        conv = run_newton & ns.converged
        newton_fail = run_newton & ~ns.converged

        # stale-Jacobian failures retry at the same h with a fresh Jacobian;
        # fresh-Jacobian failures halve h (reference/Hairer policy)
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate ----------------------------------------------
        if opts.compensated:
            # double-word accumulation: fold the step increment (and any
            # carried remainder) into the state without per-step ulp loss
            y_new, y_lo_new = cm.comp_add(st.y, st.y_lo, ns.z[:, -1, :])
            t_acc, t_lo_new = cm.comp_add(st.t, st.t_lo, h)
        else:
            y_new = st.y + ns.z[:, -1, :]
            y_lo_new = st.y_lo
            t_acc, t_lo_new = st.t + h, st.t_lo
        ze = jnp.einsum("s,msd->md", e_vec, ns.z, precision=_EINSUM_PRECISION) / h[:, None]
        if mass is not None:
            ze = jnp.einsum("...ij,m...j->m...i" if mass.ndim == 2 else "mij,mj->mi",
                            mass, ze, precision=_EINSUM_PRECISION)
        if use_slabs:
            # st.f0 was evaluated under the PREVIOUS step's slab row (the
            # dopri FSAL-leak rule): re-evaluate under the current row
            f0_use = f(st.t, st.y, fa)
        else:
            f0_use = st.f0
        err1 = (solver[0](f0_use + ze) if solver is not None
                else lu_solve(lu_r, piv_r, f0_use + ze))
        scale_e = opts.atol + opts.rtol * jnp.maximum(jnp.abs(st.y),
                                                      jnp.abs(y_new))
        if use_index:
            scale_e = scale_e / (jnp.abs(h)[:, None] ** ind_exp[None, :])
        enorm1 = cm.safe_sqrt(jnp.mean(jnp.square(err1 / scale_e), axis=-1))
        enorm1 = jnp.where(jnp.isfinite(enorm1), enorm1, 1e10)

        refine = conv & st.rejected & (enorm1 > 1.0)

        def do_refine(_):
            fe = f(st.t, st.y + err1, fa)
            err2 = (solver[0](fe + ze) if solver is not None
                    else lu_solve(lu_r, piv_r, fe + ze))
            en2 = cm.safe_sqrt(jnp.mean(jnp.square(err2 / scale_e), axis=-1))
            return jnp.where(refine, jnp.where(jnp.isfinite(en2), en2, 1e10),
                             enorm1)

        enorm = jax.lax.cond(jnp.any(refine), do_refine, lambda _: enorm1,
                             operand=None)

        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        # ---- controller ---------------------------------------------------
        h_abs = jnp.abs(h)
        niter_f = jnp.maximum(ns.niter, 1).astype(dtype)
        safety = opts.safety * (2 * max_iter + 1) / (2 * max_iter + niter_f)
        # error-estimator order is s+1 ⇒ controller exponent 1/(s+1)
        # (0.25 only for s=3; radaup.py uses the same general form)
        expo = 1.0 / (s + 1)
        have_old = (st.h_old > 0) & (st.err_old > 0) & (enorm > 0)
        mult = jnp.where(have_old,
                         h_abs / jnp.where(st.h_old == 0, 1.0, st.h_old)
                         * (st.err_old / jnp.where(enorm == 0, 1.0, enorm))
                         ** expo,
                         1.0)
        enorm_safe = jnp.maximum(enorm, 1e-16)
        gmult = jnp.minimum(1.0, mult) if opts.gustafsson else 1.0
        base_factor = gmult * enorm_safe ** -expo

        # reject path: shrink
        fac_rej = jnp.maximum(opts.min_factor, safety * base_factor)
        # accept path: clamp BOTH ways (the Gustafsson multiplier can be
        # arbitrarily small after odd step history; the reference clamps the
        # accepted factor into [FacL, FacR] too, radaute_impl.hpp:1092-1120)
        fac_acc = jnp.clip(safety * base_factor, opts.min_factor,
                           opts.max_factor)
        recompute_jac = accept & (ns.niter > 2) & (ns.rate > opts.jac_recompute)
        deadzone = accept & ~recompute_jac & (fac_acc >= opts.quot1) & \
            (fac_acc < opts.quot2)
        fac_acc = jnp.where(deadzone, 1.0, fac_acc)

        # ---- new f at accepted points (gated on any accept) ---------------
        t_new = t_acc

        def do_fnew(_):
            fn = f(t_new, y_new, fa)
            return jnp.where(accept[:, None], fn, st.f0)

        f_new = jax.lax.cond(jnp.any(accept), do_fnew, lambda _: st.f0,
                             operand=None)

        # ---- internal-differentiation tangent sweep (gated) ---------------
        if use_sens:
            k_dirs = yd0.shape[0]

            def do_tan(_):
                zd = _tangent_stages(tab, f, st.t, st.y, h, ns.z, st.yd,
                                     newton_tol, lu_r, piv_r, lu_c, piv_c,
                                     accept, args, mass=mass, args_d=args_d,
                                     gmres_solver=solver)
                ydn = jnp.where(accept[None, :, None],
                                st.yd + zd[:, :, -1, :], st.yd)
                # tangent of the collocation interpolant: same θ-polynomial
                # in Zd (dense dual output; reference ntrprad on TensorDual)
                qd = jnp.einsum("kmsd,sq->kmqd", zd, p_mat,
                                precision=_EINSUM_PRECISION)
                return ydn, qd

            def skip_tan(_):
                return st.yd, jnp.zeros((k_dirs, m, s, dim), dtype)

            yd_new, qd = jax.lax.cond(jnp.any(accept), do_tan, skip_tan,
                                      operand=None)
        else:
            yd_new = st.yd
            qd = None

        # ---- dense output & warm-start polynomial -------------------------
        q_new = jnp.einsum("msd,sq->mqd", ns.z, p_mat, precision=_EINSUM_PRECISION)  # [M, θ-power q, D]
        q_poly = jnp.where(accept[:, None, None], q_new, st.q_poly)

        out_ys = st.out_ys
        interp = None
        if use_dense or specs:
            def interp(theta):                          # [M,T] -> [M,T,D]
                tp = jnp.stack([theta ** (q + 1) for q in range(s)], axis=-1)
                return st.y[:, None, :] + jnp.einsum("mtq,mqd->mtd", tp, q_new, precision=_EINSUM_PRECISION)
        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, st.t, h, accept, interp)

        out_sd = st.out_sd
        if use_sens and use_dense:
            def collect_k(o_k, qd_k, yd_k):
                def interp_k(theta):                    # [M,T] -> [M,T,D]
                    tp = jnp.stack([theta ** (q + 1) for q in range(s)],
                                   axis=-1)
                    return yd_k[:, None, :] + jnp.einsum(
                        "mtq,mqd->mtd", tp, qd_k,
                        precision=_EINSUM_PRECISION)
                return cm.collect_dense(o_k, t_eval, st.t, h, accept,
                                        interp_k)

            out_sd = jax.vmap(collect_k)(st.out_sd, qd, st.yd)

        ev, terminate, t_ev, y_ev, ev_idx = handle_events(
            specs, st.ev, st.t, h, st.y, t_new, y_new, interp, accept, args)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)
            if use_sens:
                out_sd = jax.vmap(lambda o: cm.mask_dense_after_event(
                    o, t_eval, terminate, t_ev, h))(out_sd)

        if use_sens and specs:
            # total derivative at an event: the event time t* moves with the
            # seed direction — dt*_k = −(g_y·yd_k + g_θ·dθ_k)/(g_t + g_y·ẏ*)
            # with ẏ* = M⁻¹f(t*, y*), so the lane's terminal sensitivity is
            # yd(t*) + ẏ*·dt*_k (implicit-function correction; reference
            # EventZeroFcn on duals :2306). Mass must be invertible here
            # (the forward solver has no algebraic-structure information —
            # use radau_adjoint(n_alg=) for semi-explicit DAE events).
            theta_ev = jnp.clip((t_ev - st.t) / h, 0.0, 1.0)
            tp_ev = jnp.stack([theta_ev ** (q + 1) for q in range(s)],
                              axis=-1)                  # [M, s]
            yd_ev = st.yd + jnp.einsum("kmqd,mq->kmd", qd, tp_ev,
                                       precision=_EINSUM_PRECISION)
            zeros_sel = jnp.zeros(yd_ev.shape[:2], dtype)   # [K, M]

            def ev_tangent(_):
                f_ev = f(t_ev, y_ev, args)
                if mass is None:
                    ydot_ev = f_ev
                elif use_gmres:
                    from janus_tpu.linalg.gmres import gmres_dense_solve
                    ydot_ev = gmres_dense_solve(
                        jnp.asarray(mass, dtype), f_ev, opts.gmres_iters)
                else:
                    mb = jnp.broadcast_to(jnp.asarray(mass, dtype),
                                          (m, dim, dim))
                    lu_m, piv_m = lu_factor(mb, pivot=True)
                    ydot_ev = lu_solve(lu_m, piv_m, f_ev)
                sens_sel = yd_ev
                dts_sel = zeros_sel                         # [K, M] dt*_k
                for j, spec in enumerate(specs):
                    gfun = (lambda tt, yy, aa, _sp=spec: _sp.fn(tt, yy, aa))
                    _, gdot = jax.jvp(
                        lambda tt, yy: gfun(tt, yy, args), (t_ev, y_ev),
                        (jnp.ones_like(t_ev), ydot_ev))
                    if args_d is None:
                        gy_yd = jax.vmap(lambda yk: jax.jvp(
                            lambda tt, yy: gfun(tt, yy, args), (t_ev, y_ev),
                            (jnp.zeros_like(t_ev), yk))[1])(yd_ev)  # [K, M]
                    else:
                        # g_θ·dθ_k rides the same joint jvp (event functions
                        # may depend directly on the seeded parameters)
                        gy_yd = jax.vmap(lambda yk, ak: jax.jvp(
                            lambda yy, aa: gfun(t_ev, yy, aa), (y_ev, args),
                            (yk, ak))[1])(yd_ev, args_d)            # [K, M]
                    dts = -gy_yd / jnp.where(gdot == 0.0, 1.0, gdot)[None]
                    corr_j = yd_ev + dts[:, :, None] * ydot_ev[None]
                    sens_sel = jnp.where((ev_idx == j)[None, :, None],
                                         corr_j, sens_sel)
                    dts_sel = jnp.where((ev_idx == j)[None, :], dts,
                                        dts_sel)
                return sens_sel, dts_sel

            sens_sel, dts_sel = jax.lax.cond(
                jnp.any(terminate), ev_tangent,
                lambda _: (yd_ev, zeros_sel), operand=None)
            yd_new = jnp.where(terminate[None, :, None], sens_sel, yd_new)
            td_new = jnp.where(terminate[None, :], dts_sel, st.td)
        else:
            td_new = st.td

        # ---- running-cost quadrature (gated on any accept) -----------------
        if use_quad:
            k_q = yd0.shape[0] if use_quad_sens else 0
            if use_quad_sens:
                args_d_rows = [jax.tree_util.tree_map(lambda a, _k=k: a[_k],
                                                      args_d)
                               for k in range(k_q)] if args_d is not None \
                    else [None] * k_q
                # stage tangent values off the dense tangent polynomial:
                # yd(θ=c_i) = yd + Σ_q c_i^{q+1}·Qd_q  (exact at collocation
                # nodes)
                cpow = jnp.stack([c_nodes ** (q + 1) for q in range(s)],
                                 axis=0)                      # [q, s]

            def _ldot(ti, yi, ydik, k):
                # tangent of the integrand: l_y·yd (+ l_θ·dθ_k)
                if args_d is None:
                    return jax.jvp(lambda yy: _ql(ti, yy), (yi,), (ydik,))[1]
                return jax.jvp(lambda yy, aa: _qla(ti, yy, aa), (yi, args),
                               (ydik, args_d_rows[k]))[1]

            def do_quad(_):
                # the step's own Radau quadrature on the converged stage
                # values: q += h·Σ_i b_i·l(t + c_i·h, y + Z_i)
                vals = jnp.stack(
                    [_ql(st.t + c_nodes[i] * h, st.y + ns.z[:, i, :])
                     for i in range(s)], axis=1)             # [M, s, Q]
                inc = h[:, None] * jnp.einsum(
                    "s,msq->mq", b_vec, vals, precision=_EINSUM_PRECISION)
                if use_quad_sens:
                    yd_st = st.yd[:, :, None, :] + jnp.einsum(
                        "kmqd,qs->kmsd", qd, cpow,
                        precision=_EINSUM_PRECISION)         # [K, M, s, D]
                    ld = jnp.stack(
                        [jnp.stack([_ldot(st.t + c_nodes[i] * h,
                                          st.y + ns.z[:, i, :],
                                          yd_st[k, :, i, :], k)
                                    for i in range(s)], axis=1)
                         for k in range(k_q)])               # [K, M, s, Q]
                    inc_d = h[None, :, None] * jnp.einsum(
                        "s,kmsq->kmq", b_vec, ld,
                        precision=_EINSUM_PRECISION)
                else:
                    inc_d = None
                if specs:
                    # event-terminated lanes integrate only to t*: Radau
                    # quadrature of the partial step [t, t*] with the state
                    # read off the collocation interpolant
                    def ev_part(op):
                        inc, inc_d = op
                        th_e = jnp.clip((t_ev - st.t)
                                        / jnp.where(h == 0.0, 1.0, h),
                                        0.0, 1.0)            # [M]
                        th_i = th_e[:, None] * c_nodes[None, :]   # [M, s]
                        y_i = interp(th_i)                   # [M, s, D]
                        t_i = st.t[:, None] + th_i * h[:, None]
                        vals_e = jnp.stack(
                            [_ql(t_i[:, i], y_i[:, i, :]) for i in range(s)],
                            axis=1)
                        inc_e = (th_e * h)[:, None] * jnp.einsum(
                            "s,msq->mq", b_vec, vals_e,
                            precision=_EINSUM_PRECISION)
                        inc_out = jnp.where(terminate[:, None], inc_e, inc)
                        if not use_quad_sens:
                            return inc_out, inc_d
                        # tangent of the truncated integral: the integrand
                        # tangent over [t, t*] plus the moving endpoint's
                        # l(t*, y*)·dt*_k
                        tpow_e = jnp.stack(
                            [th_i ** (q + 1) for q in range(s)],
                            axis=1)                          # [M, q, s]
                        yd_e = st.yd[:, :, None, :] + jnp.einsum(
                            "kmqd,mqs->kmsd", qd, tpow_e,
                            precision=_EINSUM_PRECISION)
                        ld_e = jnp.stack(
                            [jnp.stack([_ldot(t_i[:, i], y_i[:, i, :],
                                              yd_e[k, :, i, :], k)
                                        for i in range(s)], axis=1)
                             for k in range(k_q)])           # [K, M, s, Q]
                        inc_de = (th_e * h)[None, :, None] * jnp.einsum(
                            "s,kmsq->kmq", b_vec, ld_e,
                            precision=_EINSUM_PRECISION)
                        l_star = _ql(t_ev, y_ev)             # [M, Q]
                        inc_de = inc_de + dts_sel[:, :, None] * l_star[None]
                        inc_d_out = jnp.where(terminate[None, :, None],
                                              inc_de, inc_d)
                        return inc_out, inc_d_out

                    inc2, inc_d2 = jax.lax.cond(
                        jnp.any(terminate), ev_part, lambda op: op,
                        operand=(inc, inc_d))
                else:
                    inc2, inc_d2 = inc, inc_d
                qa = st.q_acc + jnp.where(accept[:, None], inc2, 0.0)
                if use_quad_sens:
                    qda = st.qd_acc + jnp.where(accept[None, :, None],
                                                inc_d2, 0.0)
                else:
                    qda = st.qd_acc
                return qa, qda

            q_acc, qd_acc = jax.lax.cond(
                jnp.any(accept), do_quad, lambda _: (st.q_acc, st.qd_acc),
                operand=None)
        else:
            q_acc, qd_acc = st.q_acc, st.qd_acc

        dyn = record_step(st.dyn, run_newton | singular, st.t, h, enorm,
                          ns.niter, accept,
                          y=jnp.where(accept[:, None], y_new, st.y)
                          if opts.record_states else None)

        if _mesh_size:
            # record the accepted step into slot naccept (scatter-add with
            # mode='drop': each slot written once, overflow steps dropped —
            # the adjoint pass detects naccept > capacity and poisons)
            rows = jnp.arange(m)
            idx = st.stats["naccept"]
            af = accept.astype(dtype)
            mesh = {
                "t": st.mesh["t"].at[rows, idx].add(af * st.t, mode="drop"),
                "h": st.mesh["h"].at[rows, idx].add(af * h, mode="drop"),
                "y": st.mesh["y"].at[rows, idx].add(
                    af[:, None] * st.y, mode="drop"),
                "q": st.mesh["q"].at[rows, idx].add(
                    af[:, None, None] * q_new, mode="drop"),
            }
        else:
            mesh = st.mesh

        # ---- state update -------------------------------------------------
        h_next_abs = jnp.where(accept, h_abs * fac_acc,
                               jnp.where(reject_err, h_abs * fac_rej,
                                         jnp.where(nf_fresh, h_abs * 0.5,
                                                   h_abs)))
        h_next_abs = jnp.minimum(h_next_abs, opts.max_step)
        sign = jnp.sign(h)
        h_next = jnp.where(st.active, h_next_abs * sign, st.h)

        done = accept & last

        stats = dict(st.stats)
        stats["nfev"] = stats["nfev"] + ns.nfev + accept + refine \
            + (accept * s if use_sens else 0)
        stats["njev"] = stats["njev"] + needj
        stats["nlu"] = stats["nlu"] + needf * (1 + npair)
        stats["nsteps"] = stats["nsteps"] + (run_newton | singular)
        stats["naccept"] = stats["naccept"] + accept
        stats["nreject"] = stats["nreject"] + (reject_err | newton_fail
                                               | singular)
        stats["nnewton"] = stats["nnewton"] + ns.niter

        nsing = jnp.where(singular | newton_fail, st.nsing + 1,
                          jnp.where(accept, 0, st.nsing))
        stall = st.active & (nsing >= 7)

        exceeded = st.active & (stats["nsteps"] >= opts.max_steps) & ~done
        # double-word t resolves steps below ulp(t): scale the underflow
        # floor by eps^2 in compensated mode (true stalls hit nsing instead)
        ueps = eps * eps if opts.compensated else eps
        hmin = 16.0 * ueps * jnp.maximum(jnp.abs(t_new), 1.0)
        underflow = st.active & (h_next_abs < hmin) & ~done

        status = st.status
        status = jnp.where(done, cm.SUCCESS, status).astype(jnp.int8)
        status = jnp.where(exceeded, cm.MAX_STEPS, status).astype(jnp.int8)
        status = jnp.where(underflow, cm.STEP_UNDERFLOW, status).astype(jnp.int8)
        status = jnp.where(stall, cm.NEWTON_STALL, status).astype(jnp.int8)
        status = jnp.where(exhausted, cm.PARAMS_EXHAUSTED,
                           status).astype(jnp.int8)
        status = jnp.where(terminate, cm.EVENT_TERMINATED, status).astype(jnp.int8)
        active = (st.active & ~done & ~exceeded & ~underflow & ~stall
                  & ~terminate & ~exhausted)

        return _RadauState(
            t=jnp.where(accept, jnp.where(terminate, t_ev, t_new), st.t),
            y=jnp.where(accept[:, None],
                        jnp.where(terminate[:, None], y_ev, y_new), st.y),
            yd=yd_new,
            t_lo=jnp.where(accept & ~terminate, t_lo_new, st.t_lo * ~terminate),
            y_lo=jnp.where((accept & ~terminate)[:, None], y_lo_new,
                           st.y_lo * (~terminate)[:, None]),
            f0=f_new,
            h=h_next,
            jac=jmat, t_lin=t_lin, y_lin=y_lin,
            lu_real=lu_r, piv_real=piv_r, lu_cplx=lu_c, piv_cplx=piv_c,
            qr_vs_r=qr_vs_r, qr_r_r=qr_r_r, qr_vs_c=qr_vs_c, qr_r_c=qr_r_c,
            use_qr=use_qr,
            # deadzone lanes keep factors; everyone else refactors next time
            h_fact=jnp.where(accept & ~deadzone, 0.0,
                             jnp.where(reject_err | nf_fresh, 0.0, h_fact)),
            # the Jacobian refers to the pre-step point: stale after an accept
            current_jac=jnp.where(accept, False, current_jac),
            need_jac=jnp.where(accept, recompute_jac,
                               jnp.where(nf_stale, True,
                                         jnp.where(needj, False,
                                                   st.need_jac))),
            h_old=jnp.where(accept, h_abs, st.h_old),
            err_old=jnp.where(accept, jnp.maximum(enorm, 1e-16), st.err_old),
            rejected=jnp.where(accept, False,
                               st.rejected | reject_err | newton_fail
                               | singular),
            nsing=nsing,
            q_poly=q_poly,
            y_prev=jnp.where(accept[:, None], st.y, st.y_prev),
            h_prev=jnp.where(accept, h, st.h_prev),
            have_sol=st.have_sol | accept,
            active=active, status=status, stats=stats, out_ys=out_ys,
            out_sd=out_sd, ev=ev, dyn=dyn, mesh=mesh, q_acc=q_acc,
            qd_acc=qd_acc, td=td_new,
        )

    final = jax.lax.while_loop(cond, body, state)
    return cm.Solution(
        t=final.t, y=final.y, status=final.status, stats=final.stats,
        ts=t_eval if use_dense else None,
        ys=final.out_ys if use_dense else None,
        event_t=final.ev["event_t"] if specs else None,
        event_y=final.ev["event_y"] if specs else None,
        event_idx=final.ev["event_idx"] if specs else None,
        dyn=final.dyn,
        sens=final.yd if use_sens else None,
        mesh=final.mesh if _mesh_size else None,
        sens_ys=final.out_sd if (use_sens and use_dense) else None,
        h_next=final.h,
        quad=(final.q_acc[:, 0] if quad_scalar else final.q_acc)
        if use_quad else None,
        sens_quad=(final.qd_acc[:, :, 0] if quad_scalar else final.qd_acc)
        if use_quad_sens else None,
        sens_t=final.td if (use_sens and specs) else None,
    )
