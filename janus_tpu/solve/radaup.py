"""Variable-order Radau IIA (stages {1,3,5,7} ⇒ orders {1,5,9,13}).

The reference's RadauTe adapts the stage count per trajectory from Newton
contractivity Θ (order-change logic radaute_impl.hpp:600-650; per-stage sample
grouping set_active_stage :656-669, skipping empty groups). Lockstep batched
version: the step body loops over the DISTINCT allowed stage counts; each
order's Newton runs under ``lax.cond(any(lane holds this order))`` so absent
orders cost nothing — the exact analogue of the reference's group skipping.
Stage-shaped work buffers are padded to the largest allowed stage count.

Order control (Hairer RADAUP style, reference knobs Vitu/Vitd/hhou/hhod,
radaute.hpp:84-95): on an accepted step, fast Newton contraction
(Θ < vitu) raises the order, slow contraction (Θ > vitd) lowers it; an order
change forces refactorization.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.diag.record import init_dyn, record_step
from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok
from janus_tpu.solve import common as cm
from janus_tpu.solve.events import (handle_events, init_event_state,
                                    normalize_events)
from janus_tpu.solve.options import Options
from janus_tpu.solve.radau import (_EINSUM_PRECISION, _factorize, _newton,
                                   _tangent_stages, default_jacobian)
from janus_tpu.solve.radau_tables import radau_tableau

VITU = 0.002      # raise order when Newton contracts faster than this
VITD = 0.8        # lower order when slower than this
HHOU = 1.2        # step-size nudge on order raise
HHOD = 0.8        # step-size nudge on order lower


def ladder_orders(opts: Options, dtype, warn: bool = False):
    """The distinct stage counts the variable-order ladder may visit.

    f32 caps the ladder at s=5 (order 9): the s=7 transformed stage systems
    lose the simplified Newton at eps=1.2e-7 (observed in f32) unless the
    caller pinned min_stages == max_stages == 7 explicitly. Shared with
    ``radau_adjoint`` so the recorded-mesh width matches the forward ladder.
    """
    max_stages = opts.max_stages
    if (jnp.dtype(dtype) == jnp.float32 and max_stages > 5
            and opts.min_stages < max_stages):
        if warn:
            import warnings
            warnings.warn(
                "radaup: capping the variable-order ladder at s=5 (order 9) "
                "in float32 — the s=7 transformed stage systems lose the "
                "simplified Newton at eps=1.2e-7; pin "
                "min_stages=max_stages=7 to override", stacklevel=3)
        max_stages = 5
    return tuple(s for s in (1, 3, 5, 7)
                 if opts.min_stages <= s <= max_stages)


@struct.dataclass
class _VState:
    t: jnp.ndarray
    y: jnp.ndarray
    yd: Any                   # [K, M, D] IND tangent state (0-size unused)
    f0: jnp.ndarray
    h: jnp.ndarray
    order: jnp.ndarray        # [M] stage count (1/3/5/7)
    jac: jnp.ndarray          # [M,D,D] J, or probed precond data (gmres)
    lu_real: jnp.ndarray
    piv_real: jnp.ndarray
    lu_cplx: jnp.ndarray      # [M, Pmax, 2D, 2D]
    piv_cplx: jnp.ndarray
    t_lin: jnp.ndarray        # frozen linearization point (gmres J·v jvp)
    y_lin: jnp.ndarray
    h_fact: jnp.ndarray
    current_jac: jnp.ndarray
    need_jac: jnp.ndarray
    h_old: jnp.ndarray
    err_old: jnp.ndarray
    rejected: jnp.ndarray
    nsing: jnp.ndarray
    q_poly: jnp.ndarray       # [M, smax, D] padded collocation poly coeffs
    h_prev: jnp.ndarray
    have_sol: jnp.ndarray
    q_acc: Any                # [M, Q] running-cost quadrature (0-d unused)
    mesh: Any                 # dense= accepted-step rings
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any
    out_sd: Any               # [K, M, T, D] dense tangent samples (0-d unused)
    td: Any                   # [K, M] event-time tangents dt*_k (0-d unused)
    ev: Any
    dyn: Any


def solve_radau_vo(f: Callable, t0, tf, y0, args=None,
                   options: Optional[Options] = None, t_eval=None,
                   jac: Optional[Callable] = None, mass=None,
                   events=None, tangents=None,
                   args_tangents=None,
                   quad: Optional[Callable] = None,
                   dense: int = 0, _mesh_size: int = 0,
                   _h0=None) -> cm.Solution:
    """Variable-order Radau IIA with optional first-class IND tangents.

    dense: step-mesh capacity N > 0: store each accepted step's
    collocation polynomial (already power-form — the ladder keeps
    per-step coefficients for dense output/events) so
    ``Solution.interpolate(ts)`` evaluates the solution anywhere post
    hoc; lanes that overflow N interpolate to NaN.

    quad: optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
    (or ``[M, Q]``); ``Solution.quad`` = ∫ l dt accumulated per accepted
    step by 3-point Gauss-Legendre on the lane's own collocation
    interpolant (truncated at t* on event-terminated lanes). Quadrature
    error is O(h^6) per step regardless of the lane's order — use the
    fixed-stage radau collocation-weight rule for order-matched
    quadratures; IND quadrature sensitivities (sens_quad) also stay on
    the fixed-stage path.

    tangents / args_tangents: seed directions for internal-differentiation
    forward sensitivities (the reference's dual variable-order RadauTeD
    role, radauted_impl.hpp). Each accepted step runs ONE linear tangent
    collocation sweep at the lane's CURRENT order, reusing that order's LU
    factors — the order ladder the primal walked is exactly the one the
    tangents ride. Returned in ``Solution.sens``; composes with ``t_eval``
    (``Solution.sens_ys`` off the per-order tangent collocation polynomial,
    padded to the ladder's shared power basis) and with ``events``
    (implicit-function event-time correction; ``Solution.sens_t`` —
    the reference's EventZeroFcn-on-duals role, radauted_impl.hpp:2306).
    """
    opts = options if options is not None else Options()
    specs = normalize_events(events)
    use_sens = tangents is not None or args_tangents is not None
    mesh_cap = max(int(dense), int(_mesh_size))
    store_q = bool(mesh_cap)
    use_quad = quad is not None
    if use_quad and use_sens:
        raise ValueError("radaup quad= has no IND quadrature tangents; "
                         "use the fixed-stage 'radau' method for "
                         "sens_quad")
    orders = ladder_orders(opts, jnp.asarray(y0).dtype, warn=True)
    if len(orders) < 2:
        from janus_tpu.solve.radau import solve_radau
        return solve_radau(f, t0, tf, y0, args, options, t_eval, jac, mass,
                           events, tangents=tangents,
                           args_tangents=args_tangents, quad=quad,
                           dense=dense, _mesh_size=_mesh_size, _h0=_h0)
    smax = orders[-1]
    pmax = (smax - 1) // 2
    tabs = {s: radau_tableau(s) for s in orders}

    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    if use_quad:
        qshape = jax.eval_shape(lambda: quad(t0, y0, args)).shape
        if len(qshape) not in (1, 2) or qshape[0] != m:
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1
        qdim = 1 if quad_scalar else qshape[1]

        def _ql(t, y):
            return cm.canon_cost(quad(t, y, args))
    use_gmres = opts.stage_solver != "lu"
    if use_gmres:
        # matrix-free ladder: J·v by jvp at the frozen linearization point
        # per order's _gmres_stage_solver; st.jac holds the PROBED
        # preconditioner data (bands/blocks), never the matrix — the
        # fixed-stage radau convention (reference decom_rc_gmres role)
        if jac is not None:
            raise ValueError("stage_solver='gmres' is matrix-free (J·v by "
                             "jvp, probed structure preconditioner); "
                             "drop jac=")
        from janus_tpu.solve.radau import precond_probe_fn
        jac_fn = precond_probe_fn(f, opts.precond, opts.precond_block,
                                  jnp.asarray(y0).shape[-1])
        g_iters = 0 if opts.stage_solver == "tridiag" else opts.gmres_iters
    else:
        jac_fn = jac if jac is not None else default_jacobian(f)
    # index-2/3 DAE error/Newton weighting (shared with solve_radau)
    ind_exp, use_index = cm.index_weights(opts, dim, dtype)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))
    max_iter = opts.newton_max_iter

    f0 = f(t0, y0, args)
    if _h0 is not None:
        # signed per-lane warm start (segment chaining in solve.adjoint);
        # lanes with _h0 == 0 fall back to the automatic initial step
        direction = jnp.where(tf >= t0, 1.0, -1.0).astype(dtype)
        if mass is None:
            h_auto = cm.initial_step(f, t0, y0, f0, tf, 3, opts.rtol,
                                     opts.atol, args, opts.max_step)
        else:
            h_auto = jnp.minimum(1e-3, jnp.abs(tf - t0) * 1e-2) * direction
        h_mag = jnp.abs(jnp.broadcast_to(jnp.asarray(_h0, dtype), (m,)))
        h = jnp.where(h_mag > 0, h_mag * direction, h_auto)
    elif opts.h0 == 0.0:
        h = cm.initial_step(f, t0, y0, f0, tf, 3, opts.rtol, opts.atol,
                            args, opts.max_step)
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
        out_sd0 = jnp.where(at_t0[None, :, :, None], yd0[:, :, None, :],
                            jnp.nan)
    else:
        out_sd0 = jnp.zeros((), dtype)
    already_done = t0 == tf
    order0 = min(max(3, orders[0]), orders[-1])
    jac_shape = ((m, dim // opts.precond_block, opts.precond_block,
                  opts.precond_block)
                 if (use_gmres and opts.precond == "block")
                 else (m, 3, dim) if use_gmres else (m, dim, dim))
    state = _VState(
        t=t0, y=y0, yd=yd0, f0=f0, h=h,
        order=jnp.full((m,), order0, jnp.int32),
        jac=jnp.zeros(jac_shape, dtype),
        lu_real=jnp.zeros((m, 0, 0) if use_gmres else (m, dim, dim), dtype),
        piv_real=jnp.zeros((m, 0) if use_gmres else (m, dim), jnp.int32),
        lu_cplx=jnp.zeros((m, pmax, 0, 0) if use_gmres
                          else (m, pmax, 2 * dim, 2 * dim), dtype),
        piv_cplx=jnp.zeros((m, pmax, 0) if use_gmres
                           else (m, pmax, 2 * dim), jnp.int32),
        t_lin=t0, y_lin=y0,
        h_fact=jnp.zeros((m,), dtype),
        current_jac=jnp.zeros((m,), bool),
        need_jac=jnp.ones((m,), bool),
        h_old=jnp.zeros((m,), dtype),
        err_old=jnp.zeros((m,), dtype),
        rejected=jnp.zeros((m,), bool),
        nsing=jnp.zeros((m,), jnp.int32),
        q_poly=jnp.zeros((m, smax, dim), dtype),
        h_prev=jnp.ones((m,), dtype),
        have_sol=jnp.zeros((m,), bool),
        q_acc=jnp.zeros((m, qdim), dtype) if use_quad
        else jnp.zeros((), dtype),
        mesh={"t": jnp.zeros((m, mesh_cap), dtype),
              "h": jnp.zeros((m, mesh_cap), dtype),
              "y": jnp.zeros((m, mesh_cap, dim), dtype),
              "q": jnp.zeros((m, mesh_cap, smax, dim), dtype)}
        if store_q else {},
        active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys, out_sd=out_sd0,
        td=(jnp.zeros((yd0.shape[0], m), dtype)
            if use_sens and specs else jnp.zeros((), dtype)),
        ev=init_event_state(specs, m, dim, t0, y0, args, dtype),
        dyn=init_dyn(m, opts.record_steps, dtype),
    )
    eps = jnp.finfo(dtype).eps

    def cond(st):
        return jnp.any(st.active)

    def body(st):
        remaining = tf - st.t
        last = jnp.abs(st.h) >= jnp.abs(remaining)
        h = jnp.where(last, remaining, st.h)
        h = jnp.where(h == 0.0, eps, h)

        needj = st.need_jac & st.active

        def do_jac(_):
            jn = jac_fn(st.t, st.y, args)
            return jnp.where(needj[:, None, None], jn, st.jac)

        jmat = jax.lax.cond(jnp.any(needj), do_jac, lambda _: st.jac, None)
        current_jac = st.current_jac | needj
        t_lin = jnp.where(needj, st.t, st.t_lin)
        y_lin = jnp.where(needj[:, None], st.y, st.y_lin)
        if use_gmres:
            from janus_tpu.solve.radau import (_gmres_stage_solver,
                                               gmres_shifted_solver)

        # ---- per-order factorization + Newton ----------------------------
        lu_r, piv_r = st.lu_real, st.piv_real
        lu_c, piv_c = st.lu_cplx, st.piv_cplx
        fact_ok = jnp.ones((m,), bool)
        h_fact = st.h_fact
        conv = jnp.zeros((m,), bool)
        attempted = jnp.zeros((m,), bool)
        y_new = st.y
        ze = jnp.zeros((m, dim), dtype)
        q_new = st.q_poly
        z_buf = jnp.zeros((m, smax, dim), dtype) if use_sens else None
        niter = jnp.zeros((m,), jnp.int32)
        rate = jnp.zeros((m,), dtype)
        nfev_add = jnp.zeros((m,), jnp.int32)
        nlu_add = jnp.zeros((m,), jnp.int32)
        scale_n = opts.atol + opts.rtol * jnp.abs(st.y)
        if use_index:
            scale_n = scale_n / (jnp.abs(h)[:, None] ** ind_exp[None, :])

        solvers = {}
        for s in orders:
            tab = tabs[s]
            sel = st.active & (st.order == s)
            needf = sel & (needj | (h != h_fact))
            npair = (s - 1) // 2

            if use_gmres:
                # nothing to factor: per-order matrix-free stage solvers at
                # this step's (h, frozen linearization point); the probed
                # preconditioner data is shared across orders
                solver_s = _gmres_stage_solver(
                    tab, f, t_lin, y_lin, args, jmat, h, mass, g_iters,
                    precond=opts.precond, block=opts.precond_block)
                solvers[s] = solver_s
                ok_g = jnp.all(jnp.isfinite(jmat),
                               axis=tuple(range(1, jmat.ndim)))
                fact_ok = jnp.where(needf, ok_g, fact_ok)
                h_fact = jnp.where(needf, h, h_fact)
            else:
                def do_fact(_, tab=tab, needf=needf, npair=npair):
                    lr, pr, lc, pc, ok = _factorize(tab, h, jmat, mass,
                                                    opts.pivoting)
                    lcp = jnp.zeros((m, pmax, 2 * dim, 2 * dim), dtype)
                    pcp = jnp.zeros((m, pmax, 2 * dim), jnp.int32)
                    if npair:
                        lcp = lcp.at[:, :npair].set(lc)
                        pcp = pcp.at[:, :npair].set(pc)
                    return lr, pr, lcp, pcp, ok

                def skip_fact(_):
                    return (lu_r, piv_r, lu_c, piv_c, jnp.ones((m,), bool))

                lr, pr, lc, pc, ok = jax.lax.cond(jnp.any(needf), do_fact,
                                                  skip_fact, None)
                w = needf
                lu_r = jnp.where(w[:, None, None], lr, lu_r)
                piv_r = jnp.where(w[:, None], pr, piv_r)
                lu_c = jnp.where(w[:, None, None, None], lc, lu_c)
                piv_c = jnp.where(w[:, None, None], pc, piv_c)
                fact_ok = jnp.where(w, ok, fact_ok)
                h_fact = jnp.where(w, h, h_fact)
                nlu_add = nlu_add + w * (1 + npair)

            run_s = sel & fact_ok

            def do_newton(_, tab=tab, s=s, run_s=run_s, npair=npair):
                c_nodes = jnp.asarray(tab.c, dtype)
                # warm start from the (padded) previous collocation poly
                theta = 1.0 + c_nodes[None, :] * (h / st.h_prev)[:, None]
                powers = jnp.stack([theta ** (q + 1) for q in range(smax)],
                                   axis=-1)
                poly_at = jnp.einsum("msq,mqd->msd", powers, st.q_poly,
                                     precision=_EINSUM_PRECISION)
                poly_1 = jnp.sum(st.q_poly, axis=1)
                z0 = jnp.where(st.have_sol[:, None, None],
                               poly_at - poly_1[:, None, :],
                               jnp.zeros((m, s, dim), dtype))
                ns = _newton(tab, f, st.t, st.y, h, z0, scale_n, newton_tol,
                             lu_r, piv_r, lu_c[:, :max(npair, 1)][:, :npair]
                             if npair else lu_c[:, :0],
                             piv_c[:, :npair] if npair else piv_c[:, :0],
                             run_s, max_iter, args, mass=mass,
                             solver=solvers.get(s))
                yn = st.y + ns.z[:, -1, :]
                e_vec = jnp.asarray(tab.e, dtype)
                ze_s = jnp.einsum("s,msd->md", e_vec, ns.z,
                                  precision=_EINSUM_PRECISION) / h[:, None]
                p_mat = jnp.asarray(tab.p, dtype)
                qp = jnp.einsum("msd,sq->mqd", ns.z, p_mat,
                                precision=_EINSUM_PRECISION)
                qpad = jnp.zeros((m, smax, dim), dtype).at[:, :s].set(qp)
                out = (ns.converged, yn, ze_s, qpad, ns.niter, ns.rate,
                       ns.nfev)
                if use_sens:
                    zpad = jnp.zeros((m, smax, dim), dtype).at[:, :s].set(ns.z)
                    out = out + (zpad,)
                return out

            def skip_newton(_):
                out = (jnp.zeros((m,), bool), st.y,
                       jnp.zeros((m, dim), dtype),
                       jnp.zeros((m, smax, dim), dtype),
                       jnp.zeros((m,), jnp.int32), jnp.zeros((m,), dtype),
                       jnp.zeros((m,), jnp.int32))
                if use_sens:
                    out = out + (jnp.zeros((m, smax, dim), dtype),)
                return out

            res = jax.lax.cond(jnp.any(run_s), do_newton, skip_newton, None)
            cv, yn, ze_s, qp, ni, rt, nf = res[:7]
            conv = jnp.where(run_s, cv, conv)
            y_new = jnp.where(run_s[:, None], yn, y_new)
            ze = jnp.where(run_s[:, None], ze_s, ze)
            q_new = jnp.where(run_s[:, None, None], qp, q_new)
            if use_sens:
                z_buf = jnp.where(run_s[:, None, None], res[7], z_buf)
            niter = jnp.where(run_s, ni, niter)
            rate = jnp.where(run_s, rt, rate)
            nfev_add = nfev_add + jnp.where(run_s, nf, 0)
            attempted = attempted | run_s

        singular = st.active & ~fact_ok
        conv = attempted & conv
        newton_fail = attempted & ~conv
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate (shared: per-lane factor buffers) ------------
        if mass is not None:
            ze = jnp.einsum("...ij,m...j->m...i" if mass.ndim == 2
                            else "mij,mj->mi", mass, ze,
                            precision=_EINSUM_PRECISION)
        if use_gmres:
            # per-lane real-shift solve (γ0_s/h·M − J)⁻¹ with each lane's
            # OWN order's γ0 as the shift coefficient — the matrix-free
            # twin of the per-lane factor buffers the LU path reuses
            gam0 = jnp.zeros((m,), dtype)
            for s_ in orders:
                gam0 = jnp.where(st.order == s_,
                                 jnp.asarray(float(tabs[s_].mu_real),
                                             dtype), gam0)
            solve_err, _ = gmres_shifted_solver(
                f, t_lin, y_lin, args, jmat, gam0 / h,
                jnp.ones((m,), dtype), mass, g_iters,
                precond=opts.precond, block=opts.precond_block)
            err1 = solve_err(st.f0 + ze)
        else:
            err1 = lu_solve(lu_r, piv_r, st.f0 + ze)
        scale_e = opts.atol + opts.rtol * jnp.maximum(jnp.abs(st.y),
                                                      jnp.abs(y_new))
        if use_index:
            scale_e = scale_e / (jnp.abs(h)[:, None] ** ind_exp[None, :])
        enorm1 = cm.safe_sqrt(jnp.mean(jnp.square(err1 / scale_e), axis=-1))
        enorm1 = jnp.where(jnp.isfinite(enorm1), enorm1, 1e10)
        refine = conv & st.rejected & (enorm1 > 1.0)

        def do_refine(_):
            fe = f(st.t, st.y + err1, args)
            err2 = (solve_err(fe + ze) if use_gmres
                    else lu_solve(lu_r, piv_r, fe + ze))
            en2 = cm.safe_sqrt(jnp.mean(jnp.square(err2 / scale_e), axis=-1))
            return jnp.where(refine, jnp.where(jnp.isfinite(en2), en2, 1e10),
                             enorm1)

        enorm = jax.lax.cond(jnp.any(refine), do_refine, lambda _: enorm1,
                             None)
        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        # ---- IND tangent sweep at each lane's own order (gated) -----------
        need_qd = use_sens and (use_dense or bool(specs))
        qd_all = None
        if use_sens:
            k_dirs = yd0.shape[0]
            yd_delta = jnp.zeros((k_dirs, m, dim), dtype)
            if need_qd:
                # tangent collocation polynomial in the ladder's shared
                # power basis (zero-padded high coefficients for low-order
                # lanes — exactly the primal q_poly convention)
                qd_all = jnp.zeros((k_dirs, m, smax, dim), dtype)
            for s in orders:
                msk = accept & (st.order == s)
                np_s = (s - 1) // 2

                def do_tan(_, tab=tabs[s], s=s, msk=msk, np_s=np_s):
                    zd = _tangent_stages(
                        tab, f, st.t, st.y, h, z_buf[:, :s, :], st.yd,
                        newton_tol, lu_r, piv_r, lu_c[:, :np_s],
                        piv_c[:, :np_s], msk, args, mass=mass,
                        max_iter=max_iter, args_d=args_d,
                        gmres_solver=solvers.get(s))
                    out = (zd[:, :, -1, :],)
                    if need_qd:
                        p_s = jnp.asarray(tab.p, dtype)
                        qd = jnp.einsum("kmsd,sq->kmqd", zd, p_s,
                                        precision=_EINSUM_PRECISION)
                        out = out + (jnp.zeros((k_dirs, m, smax, dim),
                                               dtype).at[:, :, :s].set(qd),)
                    return out

                def skip_tan(_):
                    out = (jnp.zeros((k_dirs, m, dim), dtype),)
                    if need_qd:
                        out = out + (jnp.zeros((k_dirs, m, smax, dim),
                                               dtype),)
                    return out

                res_t = jax.lax.cond(jnp.any(msk), do_tan, skip_tan, None)
                yd_delta = jnp.where(msk[None, :, None], res_t[0], yd_delta)
                if need_qd:
                    qd_all = jnp.where(msk[None, :, None, None], res_t[1],
                                       qd_all)
            yd_new = jnp.where(accept[None, :, None], st.yd + yd_delta,
                               st.yd)
        else:
            yd_new = st.yd

        # ---- controller with per-lane order exponent ----------------------
        h_abs = jnp.abs(h)
        niter_f = jnp.maximum(niter, 1).astype(dtype)
        safety = opts.safety * (2 * max_iter + 1) / (2 * max_iter + niter_f)
        have_old = (st.h_old > 0) & (st.err_old > 0) & (enorm > 0)
        expo = 1.0 / (st.order.astype(dtype) + 1.0)
        enorm_safe = jnp.maximum(enorm, 1e-16)
        mult = jnp.where(have_old,
                         h_abs / jnp.where(st.h_old == 0, 1.0, st.h_old)
                         * (st.err_old / enorm_safe) ** expo, 1.0)
        base_factor = jnp.minimum(1.0, mult) * enorm_safe ** -expo
        fac_rej = jnp.maximum(opts.min_factor, safety * base_factor)
        fac_acc = jnp.clip(safety * base_factor, opts.min_factor,
                           opts.max_factor)
        recompute_jac = accept & (niter > 2) & (rate > opts.jac_recompute)
        deadzone = accept & ~recompute_jac & (fac_acc >= opts.quot1) & \
            (fac_acc < opts.quot2)
        fac_acc = jnp.where(deadzone, 1.0, fac_acc)

        # ---- order adaptation (Hairer Θ rules) ----------------------------
        order_up = accept & (rate < VITU) & (niter <= 2) & \
            (st.order < orders[-1])
        order_down = accept & ((rate > VITD) | (niter >= max_iter - 1)) & \
            (st.order > orders[0])
        order_next = jnp.where(order_up, st.order + 2,
                               jnp.where(order_down, st.order - 2, st.order))
        fac_acc = jnp.where(order_up, fac_acc * HHOU,
                            jnp.where(order_down, fac_acc * HHOD, fac_acc))
        order_changed = order_next != st.order

        t_new = st.t + h

        def do_fnew(_):
            fn = f(t_new, y_new, args)
            return jnp.where(accept[:, None], fn, st.f0)

        f_new = jax.lax.cond(jnp.any(accept), do_fnew, lambda _: st.f0, None)

        q_poly = jnp.where(accept[:, None, None], q_new, st.q_poly)
        out_ys = st.out_ys
        interp = None
        if use_dense or specs or use_quad or store_q:
            def interp(theta):
                tp = jnp.stack([theta ** (q + 1) for q in range(smax)],
                               axis=-1)
                return st.y[:, None, :] + jnp.einsum(
                    "mtq,mqd->mtd", tp, q_new, precision=_EINSUM_PRECISION)
        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, st.t, h, accept, interp)

        out_sd = st.out_sd
        if use_sens and use_dense:
            def collect_k(o_k, qd_k, yd_k):
                def interp_k(theta):                    # [M,T] -> [M,T,D]
                    tp = jnp.stack([theta ** (q + 1) for q in range(smax)],
                                   axis=-1)
                    return yd_k[:, None, :] + jnp.einsum(
                        "mtq,mqd->mtd", tp, qd_k,
                        precision=_EINSUM_PRECISION)
                return cm.collect_dense(o_k, t_eval, st.t, h, accept,
                                        interp_k)

            out_sd = jax.vmap(collect_k)(st.out_sd, qd_all, st.yd)

        ev, terminate, t_ev, y_ev, ev_idx = handle_events(
            specs, st.ev, st.t, h, st.y, t_new, y_new, interp, accept, args)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)
            if use_sens:
                out_sd = jax.vmap(lambda o: cm.mask_dense_after_event(
                    o, t_eval, terminate, t_ev, h))(out_sd)

        if use_sens and specs:
            # total derivative at an event: dt*_k = −(g_y·yd_k + g_θ·dθ_k)
            # / (g_t + g_y·ẏ*) with ẏ* = M⁻¹f(t*, y*); the lane's terminal
            # sensitivity is yd(t*) + ẏ*·dt*_k (implicit-function
            # correction, same formula as the fixed-stage path; reference
            # EventZeroFcn on duals, radauted_impl.hpp:2306). yd(t*) comes
            # off the padded tangent collocation polynomial at the lane's
            # own order.
            theta_ev = jnp.clip((t_ev - st.t) / h, 0.0, 1.0)
            tp_ev = jnp.stack([theta_ev ** (q + 1) for q in range(smax)],
                              axis=-1)                  # [M, smax]
            yd_ev = st.yd + jnp.einsum("kmqd,mq->kmd", qd_all, tp_ev,
                                       precision=_EINSUM_PRECISION)
            zeros_sel = jnp.zeros(yd_ev.shape[:2], dtype)   # [K, M]

            def ev_tangent(_):
                f_ev = f(t_ev, y_ev, args)
                if mass is None:
                    ydot_ev = f_ev
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

        if use_quad:
            q_acc = cm.quad_gl3_step(_ql, st.t, h, interp, accept,
                                     terminate, t_ev, st.q_acc)
        else:
            q_acc = st.q_acc

        if store_q:
            # dense= rings: q_new IS the shared power basis. where, not
            # accept*: rejected lanes carry NaN coefficients and 0·NaN
            # poisons dead slots (CLAUDE.md round-4 mesh rule)
            rows_dq = jnp.arange(m)
            idxq = st.stats["naccept"]
            mesh = {
                "t": st.mesh["t"].at[rows_dq, idxq].add(
                    jnp.where(accept, st.t, 0.0), mode="drop"),
                "h": st.mesh["h"].at[rows_dq, idxq].add(
                    jnp.where(accept, h, 0.0), mode="drop"),
                "y": st.mesh["y"].at[rows_dq, idxq].add(
                    jnp.where(accept[:, None], st.y, 0.0), mode="drop"),
                "q": st.mesh["q"].at[rows_dq, idxq].add(
                    jnp.where(accept[:, None, None], q_new, 0.0),
                    mode="drop"),
            }
        else:
            mesh = st.mesh

        dyn = record_step(st.dyn, attempted | singular, st.t, h, enorm,
                          niter, accept)

        h_next_abs = jnp.where(accept, h_abs * fac_acc,
                               jnp.where(reject_err, h_abs * fac_rej,
                                         jnp.where(nf_fresh, h_abs * 0.5,
                                                   h_abs)))
        h_next_abs = jnp.minimum(h_next_abs, opts.max_step)
        h_next = jnp.where(st.active, h_next_abs * jnp.sign(h), st.h)
        done = accept & last

        stats = dict(st.stats)
        stats["nfev"] = stats["nfev"] + nfev_add + accept + refine
        stats["njev"] = stats["njev"] + needj
        stats["nlu"] = stats["nlu"] + nlu_add
        stats["nsteps"] = stats["nsteps"] + (attempted | singular)
        stats["naccept"] = stats["naccept"] + accept
        stats["nreject"] = stats["nreject"] + (reject_err | newton_fail
                                               | singular)
        stats["nnewton"] = stats["nnewton"] + niter

        nsing = jnp.where(singular | newton_fail, st.nsing + 1,
                          jnp.where(accept, 0, st.nsing))
        stall = st.active & (nsing >= 7)
        exceeded = st.active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test (an absolute floor rejects
        # legitimate tiny f32 steps; cf. solve/radau.py)
        underflow = st.active & (0.1 * h_next_abs <= eps * jnp.abs(t_new)) \
            & ~done

        status = st.status
        status = jnp.where(done, cm.SUCCESS, status).astype(jnp.int8)
        status = jnp.where(exceeded, cm.MAX_STEPS, status).astype(jnp.int8)
        status = jnp.where(underflow, cm.STEP_UNDERFLOW, status).astype(jnp.int8)
        status = jnp.where(stall, cm.NEWTON_STALL, status).astype(jnp.int8)
        status = jnp.where(terminate, cm.EVENT_TERMINATED, status).astype(jnp.int8)
        active = st.active & ~done & ~exceeded & ~underflow & ~stall & \
            ~terminate

        return _VState(
            t=jnp.where(accept, jnp.where(terminate, t_ev, t_new), st.t),
            y=jnp.where(accept[:, None],
                        jnp.where(terminate[:, None], y_ev, y_new), st.y),
            yd=yd_new,
            f0=f_new,
            h=h_next,
            order=jnp.where(st.active, order_next, st.order),
            jac=jmat,
            lu_real=lu_r, piv_real=piv_r, lu_cplx=lu_c, piv_cplx=piv_c,
            t_lin=t_lin, y_lin=y_lin,
            h_fact=jnp.where((accept & ~deadzone) | reject_err | nf_fresh
                             | order_changed, 0.0, h_fact),
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
            h_prev=jnp.where(accept, h, st.h_prev),
            have_sol=st.have_sol | accept,
            q_acc=q_acc,
            mesh=mesh,
            active=active, status=status, stats=stats, out_ys=out_ys,
            out_sd=out_sd, td=td_new, ev=ev, dyn=dyn,
        )

    final = jax.lax.while_loop(cond, body, state)
    return cm.Solution(
        t=final.t, y=final.y, status=final.status, stats=final.stats,
        sens=final.yd if use_sens else None,
        sens_ys=final.out_sd if (use_sens and use_dense) else None,
        sens_t=final.td if (use_sens and specs) else None,
        quad=(final.q_acc[:, 0] if quad_scalar else final.q_acc)
        if use_quad else None,
        mesh=final.mesh if store_q else None,
        ts=t_eval if use_dense else None,
        ys=final.out_ys if use_dense else None,
        h_next=final.h,
        event_t=final.ev["event_t"] if specs else None,
        event_y=final.ev["event_y"] if specs else None,
        event_idx=final.ev["event_idx"] if specs else None,
        dyn=final.dyn,
    )
