"""Batched RODAS4 — stiffly accurate Rosenbrock 4(3) with its own dense output.

The honest ``method='rodas'``: L-stable, stiffly accurate (the last stage is
evaluated at t+h and the update includes it, so the stage order is preserved
on index-1 DAEs where GRK4T degrades), embedded 3rd-order error estimate that
costs nothing extra (the 6th stage increment IS the error vector), and the
method's own 3rd-order continuous extension.

Algorithm: Hairer & Wanner, Solving ODEs II (1996), Sec. IV.7 — the RODAS
scheme with the standard (a_ij, c_ij, d_i, gamma) implementation form that
avoids J^-1 products; the reference vendors Hairer's public Fortran at
src/fortran/radau.f:532-888 (ROSCOR) with the coefficient set at :889-940
(ROCOE METH=1). Coefficients below are that published METH=1 RODAS4 set; an
order-conditions test (tests/test_rodas.py) verifies them independently
against the Rosenbrock order-4 conditions.

Per step (E = M/(h*gamma) - J factored once, 6 solves, 5 f-evals):

  k_i = E^-1 [ f(t + c_i h, y + sum_j a_ij k_j) + h d_i f_t
               + M sum_j (c_ij / h) k_j ]
  y_emb = y + a_51 k1 + ... + a_54 k4 + k5      (order 3, stiffly accurate)
  y_new = y_emb + k6                             (order 4)
  err   = ||k6||_sc                              (embedded difference)

The Jacobian (and f_t, by forward-mode JVP in t) is evaluated at every new
step point — Rosenbrock methods need a current J for their order, unlike the
W-method-style reuse in solve/radau.py; rejections reuse both.

Batched in the house lockstep style (cf. solve/radau.py): one lax.while_loop,
per-lane h/accept/singular-retry lanes, Gustafsson predictive controller
(rodas.f:838-846), events + t_eval on the cubic continuous extension
(CONTRO form, rodas.f:861-888).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu import config
from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok
from janus_tpu.solve import common as cm
from janus_tpu.solve.events import (handle_events, init_event_state,
                                    normalize_events)
from janus_tpu.solve.options import Options
from janus_tpu.solve.radau import default_jacobian

_EINSUM_PRECISION = jax.lax.Precision.HIGHEST

# Published RODAS4 coefficients (Hairer & Wanner 1996; rodas.f ROCOE METH=1)
GAMMA = 0.25
C2, C3, C4 = 0.386, 0.21, 0.63
D1, D2, D3, D4 = 0.25, -0.1043, 0.1035, -0.03620000000000023
A21 = 1.544
A31, A32 = 0.9466785280815826, 0.2557011698983284
A41, A42, A43 = 3.314825187068521, 2.896124015972201, 0.9986419139977817
A51, A52, A53, A54 = (1.221224509226641, 6.019134481288629,
                      12.53708332932087, -0.6878860361058950)
C21 = -5.6688
C31, C32 = -2.430093356833875, -0.2063599157091915
C41, C42, C43 = -0.1073529058151375, -9.594562251023355, -20.47028614809616
C51, C52, C53, C54 = (7.496443313967647, -10.24680431464352,
                      -33.99990352819905, 11.70890893206160)
C61, C62, C63, C64, C65 = (8.083246795921522, -7.981132988064893,
                           -31.52159432874371, 16.31930543123136,
                           -6.058818238834054)
# dense-output combinations (rodas.f D21..D35)
D21, D22, D23, D24, D25 = (10.12623508344586, -7.487995877610167,
                           -34.80091861555747, -7.992771707568823,
                           1.025137723295662)
D31, D32, D33, D34, D35 = (-0.6762803392801253, 6.087714651680015,
                           16.43084320892478, 24.76722511418386,
                           -6.594389125716872)


@struct.dataclass
class _RodasState:
    t: jnp.ndarray
    y: jnp.ndarray
    f1: jnp.ndarray           # f at (t, y)
    fx: jnp.ndarray           # df/dt at (t, y)
    h: jnp.ndarray
    jac: jnp.ndarray
    lu: jnp.ndarray
    piv: jnp.ndarray
    h_fact: jnp.ndarray       # signed h the E factors were built with
    need_jac: jnp.ndarray
    h_acc: jnp.ndarray        # Gustafsson memory
    err_acc: jnp.ndarray
    rejected: jnp.ndarray
    nsing: jnp.ndarray
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any
    ev: Any
    yd: Any                   # [K, M, D] IND tangents (0-size when unused)
    q_acc: Any                # [M, Q] running-cost quadrature (0-d unused)
    mesh: Any                 # accepted-step rings for the discrete adjoint


def solve_rodas(f: Callable, t0, tf, y0, args=None,
                options: Optional[Options] = None, t_eval=None,
                jac: Optional[Callable] = None, mass=None,
                events=None, tangents=None,
                args_tangents=None,
                quad: Optional[Callable] = None, dense: int = 0,
                step_args=None,
                _mesh_size: int = 0, _h0=None) -> cm.Solution:
    """Batched adaptive RODAS4 solve (index-1 DAE capable via ``mass``).

    dense: step-mesh capacity N > 0: store each accepted step's CONTRO
    dense-output cubic (expanded into the shared power basis
    y_k + Σ_p θ^{p+1}·q_k[p]) so ``Solution.interpolate(ts)`` evaluates
    the solution anywhere post hoc — the same scipy ``sol.sol(t)`` role as
    radau's ``dense=``. Size N above the worst lane's step count;
    overflowing lanes interpolate to NaN (never silently-wrong values).

    quad: optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
    (or ``[M, Q]``); ``Solution.quad`` accumulates ∫ l dt per accepted step
    by 3-point Gauss-Legendre on the step's CONTRO dense-output cubic
    (exact to degree 5 — above the interpolant's own order, so the
    quadrature error is dominated by the method's O(h⁴) like the state).
    Event-terminated lanes integrate only to t* (the partial step is
    re-quadratured on the scaled interpolant). The CVODES
    quadrature-integration role on the Rosenbrock family.

    tangents / args_tangents: first-class internal-differentiation forward
    sensitivities. Rosenbrock steps are linearly implicit, so the tangent of
    one step is DIRECT (no iteration): each tangent increment solves the
    step's already-factored E = M/(hγ) − J against the exact derivative of
    the stage right-hand side — a jvp of f at the converged stage point,
    plus the second-order term dJ[δ]·k_i from d(E)·k_i (one linearization of
    the Jacobian map per step, shared by all K directions; RODAS is NOT a
    W-method, so unlike seulex this term is required for full tangent
    order) and the d/dt cross term dfₜ[δ]. Six back-substitutions per
    direction, zero extra factorizations (the reference's solve_LUdual role,
    radauted_impl.hpp:1901-1936, on its rosenbrock_torch_gmres family).
    Results in ``Solution.sens`` [K, M, D]; terminal mode only (t_eval /
    events with tangents raise — use jax.jvp through the solve there).

    step_args: optional pytree of per-ACCEPTED-step parameter slabs (the
    reference's adaptive-stepper theta/nparams_step semantics, extended to
    the Rosenbrock family): every leaf has leading axis S; a lane's k-th
    accepted-step ATTEMPT evaluates all six stages, the Jacobian, and
    df/dt with row k, passed to f as ``(args, slab_k)``. Leaves with
    second axis M are per-lane tables. Lanes needing a row past S fail
    with status PARAMS_EXHAUSTED (per-lane). Terminal/t_eval/events modes;
    tangents= and the discrete adjoint raise (slab rows are step-indexed —
    the replay has no slab index; use ``models.controls`` time-indexed
    schedules for differentiable controls).
    """
    opts = options if options is not None else Options()
    store_q = bool(dense)
    if dense:
        # public face of the adjoint's step rings: also store the dense-
        # output polynomial of every accepted step for Solution.interpolate
        _mesh_size = max(_mesh_size, int(dense))
    if opts.nind2 or opts.nind3:
        raise ValueError("Options.nind2/nind3 (higher-index DAE error "
                         "weighting) is honored by 'radau'/'radaup' only; "
                         "rodas is index-1 capable via mass= alone")
    specs = normalize_events(events)
    use_pallas = config.use_stage_lu_kernel(opts)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    jac_fn = jac if jac is not None else default_jacobian(f)

    use_sens = tangents is not None or args_tangents is not None
    if use_sens and (t_eval is not None or events is not None):
        raise ValueError("solve_rodas(tangents=) is terminal-mode only "
                         "(no tangent dense output/event correction); "
                         "use jax.jvp through the solve for those")
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
        k_dirs = yd0.shape[0]
        args_d_rows = [jax.tree_util.tree_map(lambda a, _k=k: a[_k], args_d)
                       for k in range(k_dirs)] if args_d is not None \
            else [None] * k_dirs
    else:
        args_d = None
        yd0 = jnp.zeros((0, m, dim), dtype)
        k_dirs = 0

    use_slabs = step_args is not None
    if use_slabs:
        if use_sens:
            raise ValueError("step_args= does not compose with tangents= "
                             "(slab rows are step-indexed; seed the slab "
                             "leaves via jax.jvp instead)")
        if _mesh_size:
            raise ValueError("step_args= does not compose with the discrete "
                             "adjoint / dense= (the replay has no slab "
                             "index); use models.controls time-indexed "
                             "schedules for differentiable controls")
        n_slabs, slab_at = cm.make_slab_selector(step_args, m, dtype)

    def ft_at(t, y, aa):
        ones = jnp.ones_like(t)
        _, out = jax.jvp(lambda tt: f(tt, y, aa), (t,), (ones,))
        return out

    def mdot(v):
        if mass is None:
            return v
        if mass.ndim == 2:
            return jnp.einsum("ij,mj->mi", mass, v,
                              precision=_EINSUM_PRECISION)
        return jnp.einsum("mij,mj->mi", mass, v, precision=_EINSUM_PRECISION)

    args0 = (args, slab_at(jnp.zeros((m,), jnp.int32))) if use_slabs \
        else args
    f0 = f(t0, y0, args0)
    if _h0 is not None:
        # per-lane warm-start step (segment chaining, solve/adjoint_rodas):
        # lanes with _h0 == 0 fall back to the automatic initial step
        direction = jnp.where(tf >= t0, 1.0, -1.0).astype(dtype)
        h_mag = jnp.abs(jnp.broadcast_to(jnp.asarray(_h0, dtype), (m,)))
        h_auto = jnp.abs(cm.initial_step(f, t0, y0, f0, tf, 4, opts.rtol,
                                         opts.atol, args0, opts.max_step)) \
            if mass is None else jnp.minimum(1e-3, jnp.abs(tf - t0) * 1e-2)
        h_mag = jnp.where(h_mag > 0, h_mag, h_auto)
        h = jnp.minimum(h_mag, jnp.abs(tf - t0)) * direction
    elif opts.h0 == 0.0:
        if mass is None:
            h = cm.initial_step(f, t0, y0, f0, tf, 4, opts.rtol, opts.atol,
                                args0, opts.max_step)
        else:
            # singular-mass systems: f0 is not a derivative on the algebraic
            # rows; start small (same policy as solve/radau.py)
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
        qshape = jax.eval_shape(lambda: quad(t0, y0, args)).shape
        if qshape not in ((m,),) and (len(qshape) != 2 or qshape[0] != m):
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1
        qdim = 1 if quad_scalar else qshape[1]

        def _ql(t, y):                       # canon [M, Q]
            return cm.canon_cost(quad(t, y, args))
        q_acc0 = jnp.zeros((m, qdim), dtype)
    else:
        q_acc0 = jnp.zeros((), dtype)

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject"))
    stats["nfev"] = stats["nfev"] + 2
    if _mesh_size:
        # accepted-step rings for the discrete adjoint (solve/adjoint_rodas):
        # (t, h, y) at the START of each accepted step, written once per slot
        # by scatter-add with mode='drop' (overflow steps dropped; the
        # adjoint pass detects naccept > capacity and poisons the gradient)
        mesh0 = {"t": jnp.zeros((m, _mesh_size), dtype),
                 "h": jnp.zeros((m, _mesh_size), dtype),
                 "y": jnp.zeros((m, _mesh_size, dim), dtype)}
        if store_q:
            mesh0["q"] = jnp.zeros((m, _mesh_size, 3, dim), dtype)
    else:
        mesh0 = {}
    already_done = t0 == tf
    state = _RodasState(
        t=t0, y=y0, f1=f0, fx=jnp.zeros((m, dim), dtype), h=h,
        jac=jnp.zeros((m, dim, dim), dtype),
        lu=jnp.zeros((m, dim, dim), dtype),
        piv=jnp.zeros((m, dim), jnp.int32),
        h_fact=jnp.zeros((m,), dtype),
        need_jac=jnp.ones((m,), bool),
        h_acc=jnp.zeros((m,), dtype),
        err_acc=jnp.zeros((m,), dtype),
        rejected=jnp.zeros((m,), bool),
        nsing=jnp.zeros((m,), jnp.int32),
        active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys,
        ev=init_event_state(specs, m, dim, t0, y0, args, dtype),
        yd=yd0,
        q_acc=q_acc0,
        mesh=mesh0,
    )
    eps = jnp.finfo(dtype).eps
    eye = jnp.eye(dim, dtype=dtype)

    def cond(st):
        return jnp.any(st.active)

    def body(st):
        remaining = tf - st.t
        last = jnp.abs(st.h) >= jnp.abs(remaining)
        h = jnp.where(last, remaining, st.h)
        h = jnp.where(h == 0.0, eps, h)

        if use_slabs:
            # a lane's k-th accepted-step attempt (all stages + J + f_t)
            # runs on slab row k (the reference's nparams_step semantics)
            exhausted = st.active & (st.stats["naccept"] >= n_slabs)
            fa = (args, slab_at(st.stats["naccept"]))
        else:
            exhausted = jnp.zeros((m,), bool)
            fa = args

        # ---- Jacobian + f + df/dt at the step point (every new point) ----
        needj = st.need_jac & st.active

        def do_jac(_):
            jn = jac_fn(st.t, st.y, fa)
            f1n = f(st.t, st.y, fa)
            fxn = ft_at(st.t, st.y, fa)
            return (jnp.where(needj[:, None, None], jn, st.jac),
                    jnp.where(needj[:, None], f1n, st.f1),
                    jnp.where(needj[:, None], fxn, st.fx))

        jmat, f1, fx = jax.lax.cond(
            jnp.any(needj), do_jac, lambda _: (st.jac, st.f1, st.fx), None)

        # ---- factor E = M/(h*gamma) - J (gated on h or J change) ---------
        needf = st.active & (needj | (h != st.h_fact))

        def do_fact(_):
            mm = eye[None] if mass is None else (
                mass[None] if mass.ndim == 2 else mass)
            emat = mm / (h * GAMMA)[:, None, None] - jmat
            if use_pallas:
                from janus_tpu.solve.radau import _pallas_lu_factor
                lu_n, piv_n = _pallas_lu_factor(emat)
            else:
                lu_n, piv_n = lu_factor(emat, pivot=opts.pivoting)
            ok = lu_ok(lu_n)
            return (jnp.where(needf[:, None, None], lu_n, st.lu),
                    jnp.where(needf[:, None], piv_n, st.piv),
                    jnp.where(needf, ok, jnp.ones((m,), bool)),
                    jnp.where(needf, h, st.h_fact))

        lu_m, piv_m, fact_ok, h_fact = jax.lax.cond(
            jnp.any(needf), do_fact,
            lambda _: (st.lu, st.piv, jnp.ones((m,), bool), st.h_fact), None)
        singular = st.active & ~fact_ok

        # ---- the 6 stages -------------------------------------------------
        hc = h[:, None]

        if use_pallas:
            from janus_tpu.ops import lu_solve as kernel_solve

            def slv(rhs):
                return kernel_solve(lu_m, rhs)
        else:
            def slv(rhs):
                return lu_solve(lu_m, piv_m, rhs)

        k1 = slv(f1 + (h * D1)[:, None] * fx)
        f2 = f(st.t + C2 * h, st.y + A21 * k1, fa)
        k2 = slv(f2 + (h * D2)[:, None] * fx + mdot(C21 * k1) / hc)
        f3 = f(st.t + C3 * h, st.y + A31 * k1 + A32 * k2, fa)
        k3 = slv(f3 + (h * D3)[:, None] * fx
                 + mdot(C31 * k1 + C32 * k2) / hc)
        f4 = f(st.t + C4 * h, st.y + A41 * k1 + A42 * k2 + A43 * k3, fa)
        k4 = slv(f4 + (h * D4)[:, None] * fx
                 + mdot(C41 * k1 + C42 * k2 + C43 * k3) / hc)
        y5 = st.y + A51 * k1 + A52 * k2 + A53 * k3 + A54 * k4
        t_new = st.t + h
        f5 = f(t_new, y5, fa)
        k5 = slv(f5 + mdot(C51 * k1 + C52 * k2 + C53 * k3 + C54 * k4) / hc)
        y_emb = y5 + k5                               # order-3 embedded
        f6 = f(t_new, y_emb, fa)
        k6 = slv(f6 + mdot(C61 * k1 + C62 * k2 + C63 * k3 + C64 * k4
                           + C65 * k5) / hc)
        y_new = y_emb + k6                            # order-4 solution

        # ---- error estimate: the 6th increment is the embedded diff ------
        scale = opts.atol + opts.rtol * jnp.maximum(jnp.abs(st.y),
                                                    jnp.abs(y_new))
        enorm = cm.safe_sqrt(jnp.mean(jnp.square(k6 / scale), axis=-1))
        enorm = jnp.where(jnp.isfinite(enorm) & jnp.all(
            jnp.isfinite(y_new), axis=-1), enorm, 1e10)
        enorm = jnp.maximum(enorm, 1e-16)

        ok_step = st.active & fact_ok & ~exhausted
        accept = ok_step & (enorm <= 1.0)
        reject = ok_step & (enorm > 1.0)

        # ---- controller (order 4 => exponent 1/4) + Gustafsson ------------
        h_abs = jnp.abs(h)
        factor = jnp.clip(opts.safety * enorm ** -0.25,
                          opts.min_factor, opts.max_factor)
        if opts.gustafsson:
            have = st.h_acc > 0
            gfac = (opts.safety * (h_abs / jnp.where(have, st.h_acc, 1.0))
                    * (st.err_acc / jnp.maximum(enorm * enorm, 1e-32)) ** 0.25)
            gfac = jnp.clip(gfac, opts.min_factor, opts.max_factor)
            factor = jnp.where(accept & have, jnp.minimum(factor, gfac),
                               factor)
        # after a rejection do not regrow immediately (rodas.f:848)
        factor = jnp.where(accept & st.rejected, jnp.minimum(factor, 1.0),
                           factor)

        # ---- dense output & events (cubic CONTRO extension) --------------
        out_ys = st.out_ys
        interp = None
        if use_dense or specs or use_quad or store_q:
            cont2 = D21 * k1 + D22 * k2 + D23 * k3 + D24 * k4 + D25 * k5
            cont3 = D31 * k1 + D32 * k2 + D33 * k3 + D34 * k4 + D35 * k5

            def interp(s):                            # [M,T] -> [M,T,D]
                se = s[..., None]
                return (st.y[:, None, :] * (1.0 - se)
                        + se * (y_new[:, None, :]
                                + (1.0 - se) * (cont2[:, None, :]
                                                + se * cont3[:, None, :])))

        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, st.t, h, accept, interp)

        ev, terminate, t_ev, y_ev, _ev_idx = handle_events(
            specs, st.ev, st.t, h, st.y, t_new, y_new, interp, accept, args)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)

        # ---- running-cost quadrature (gated on any accept) ----------------
        if use_quad:
            q_acc = cm.quad_gl3_step(_ql, st.t, h, interp, accept,
                                     terminate, t_ev, st.q_acc)
        else:
            q_acc = st.q_acc

        # ---- IND tangent sweep (exact derivative of the frozen-h step) ----
        if use_sens:
            stage_pts = ((st.t, st.y),
                         (st.t + C2 * h, st.y + A21 * k1),
                         (st.t + C3 * h, st.y + A31 * k1 + A32 * k2),
                         (st.t + C4 * h,
                          st.y + A41 * k1 + A42 * k2 + A43 * k3),
                         (t_new, y5), (t_new, y_emb))

            def do_tan(_):
                yd = st.yd
                # linearize f at the six converged stage points and the
                # Jacobian/ft maps at the step point — ONCE, shared by all
                # K directions; per direction each stage costs one
                # linear-map application + one back-substitution
                lins = []
                for ti, yi in stage_pts:
                    if args_d is None:
                        _, ln = jax.linearize(
                            lambda yy, _t=ti: f(_t, yy, args), yi)
                        lins.append(lambda dy, _da, _ln=ln: _ln(dy))
                    else:
                        _, ln = jax.linearize(
                            lambda yy, aa, _t=ti: f(_t, yy, aa), yi, args)
                        lins.append(lambda dy, da, _ln=ln: _ln(dy, da))
                if args_d is None:
                    _, jlin = jax.linearize(
                        lambda yy: jac_fn(st.t, yy, args), st.y)
                    _, xlin = jax.linearize(
                        lambda yy: ft_at(st.t, yy, args), st.y)
                    jl = lambda dy, _da: jlin(dy)          # noqa: E731
                    xl = lambda dy, _da: xlin(dy)          # noqa: E731
                else:
                    _, jl = jax.linearize(
                        lambda yy, aa: jac_fn(st.t, yy, aa), st.y, args)
                    _, xl = jax.linearize(
                        lambda yy, aa: ft_at(st.t, yy, aa), st.y, args)

                def app(ln, dys):              # [K, M, ...] per direction
                    if args_d is None:
                        return jax.vmap(lambda d: ln(d, None))(dys)
                    return jnp.stack([ln(dys[q], args_d_rows[q])
                                      for q in range(k_dirs)])

                djac = app(jl, yd)             # [K, M, D, D] = dJ[δ_k]
                dfx = app(xl, yd)              # [K, M, D]   = dfₜ[δ_k]

                def djk(ki):                   # d(E)·k_i = −dJ[δ]·k_i term
                    return jnp.einsum("kmij,mj->kmi", djac, ki,
                                      precision=_EINSUM_PRECISION)

                def mdot_k(v):                 # [K, M, D]
                    if mass is None:
                        return v
                    eq = ("ij,kmj->kmi" if mass.ndim == 2
                          else "mij,kmj->kmi")
                    return jnp.einsum(eq, mass, v,
                                      precision=_EINSUM_PRECISION)

                def slv_k(rhs):
                    if use_pallas:
                        return jax.vmap(
                            lambda b: kernel_solve(lu_m, b))(rhs)
                    return jax.vmap(
                        lambda b: lu_solve(lu_m, piv_m, b))(rhs)

                hck = h[None, :, None]
                dk1 = slv_k(app(lins[0], yd)
                            + (h * D1)[None, :, None] * dfx + djk(k1))
                d2 = yd + A21 * dk1
                dk2 = slv_k(app(lins[1], d2)
                            + (h * D2)[None, :, None] * dfx
                            + mdot_k(C21 * dk1) / hck + djk(k2))
                d3 = yd + A31 * dk1 + A32 * dk2
                dk3 = slv_k(app(lins[2], d3)
                            + (h * D3)[None, :, None] * dfx
                            + mdot_k(C31 * dk1 + C32 * dk2) / hck + djk(k3))
                d4 = yd + A41 * dk1 + A42 * dk2 + A43 * dk3
                dk4 = slv_k(app(lins[3], d4)
                            + (h * D4)[None, :, None] * dfx
                            + mdot_k(C41 * dk1 + C42 * dk2 + C43 * dk3)
                            / hck + djk(k4))
                d5 = yd + A51 * dk1 + A52 * dk2 + A53 * dk3 + A54 * dk4
                dk5 = slv_k(app(lins[4], d5)
                            + mdot_k(C51 * dk1 + C52 * dk2 + C53 * dk3
                                     + C54 * dk4) / hck + djk(k5))
                d_emb = d5 + dk5
                dk6 = slv_k(app(lins[5], d_emb)
                            + mdot_k(C61 * dk1 + C62 * dk2 + C63 * dk3
                                     + C64 * dk4 + C65 * dk5) / hck
                            + djk(k6))
                ydn = d_emb + dk6
                return jnp.where(accept[None, :, None], ydn, st.yd)

            yd_new = jax.lax.cond(jnp.any(accept), do_tan,
                                  lambda _: st.yd, None)
        else:
            yd_new = st.yd

        if _mesh_size:
            rows = jnp.arange(m)
            idx = st.stats["naccept"]
            af = accept.astype(dtype)
            mesh = {
                "t": st.mesh["t"].at[rows, idx].add(af * st.t, mode="drop"),
                "h": st.mesh["h"].at[rows, idx].add(af * h, mode="drop"),
                "y": st.mesh["y"].at[rows, idx].add(
                    af[:, None] * st.y, mode="drop"),
            }
            if store_q:
                # CONTRO cubic y(θ) = y0(1−θ) + θ[y1 + (1−θ)(c2 + θ·c3)]
                # expanded into the shared power basis y0 + Σ_p θ^{p+1} q[p]
                q_new = jnp.stack([(y_new - st.y) + cont2,
                                   cont3 - cont2,
                                   -cont3], axis=1)          # [M, 3, D]
                # where, not af*: finished lanes carry NaN stage values and
                # 0·NaN would poison the (dead) slot, which the interpolate
                # one-hot sum still touches (CLAUDE.md round-4 mesh rule)
                q_new = jnp.where(accept[:, None, None], q_new, 0.0)
                mesh["q"] = st.mesh["q"].at[rows, idx].add(
                    q_new, mode="drop")
        else:
            mesh = st.mesh

        # ---- bookkeeping --------------------------------------------------
        done = accept & last
        h_next_abs = jnp.where(accept | reject, h_abs * factor,
                               jnp.where(singular, h_abs * 0.5, h_abs))
        h_next_abs = jnp.minimum(h_next_abs, opts.max_step)
        h_next = jnp.where(st.active, h_next_abs * jnp.sign(h), st.h)

        stats = dict(st.stats)
        stats["nfev"] = stats["nfev"] + ok_step * 5 + needj
        stats["njev"] = stats["njev"] + needj
        stats["nlu"] = stats["nlu"] + needf
        stats["nsteps"] = stats["nsteps"] + (ok_step | singular)
        stats["naccept"] = stats["naccept"] + accept
        stats["nreject"] = stats["nreject"] + (reject | singular)

        nsing = jnp.where(singular, st.nsing + 1,
                          jnp.where(accept, 0, st.nsing))
        stall = st.active & (nsing >= 5)
        exceeded = st.active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test (rodas.f:607)
        underflow = st.active & (0.1 * h_next_abs <= eps * jnp.abs(t_new)) \
            & ~done

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

        return _RodasState(
            t=jnp.where(accept, jnp.where(terminate, t_ev, t_new), st.t),
            y=jnp.where(accept[:, None],
                        jnp.where(terminate[:, None], y_ev, y_new), st.y),
            f1=f1, fx=fx,
            h=h_next,
            jac=jmat, lu=lu_m, piv=piv_m,
            h_fact=jnp.where(accept, 0.0, h_fact),
            need_jac=jnp.where(accept, True,
                               jnp.where(needj, False, st.need_jac)),
            h_acc=jnp.where(accept, h_abs, st.h_acc),
            err_acc=jnp.where(accept, jnp.maximum(enorm, 1e-2), st.err_acc),
            rejected=jnp.where(accept, False, st.rejected | reject),
            nsing=nsing,
            active=active, status=status, stats=stats, out_ys=out_ys,
            ev=ev, yd=yd_new, q_acc=q_acc, mesh=mesh,
        )

    final = jax.lax.while_loop(cond, body, state)
    return cm.Solution(
        t=final.t, y=final.y, status=final.status, stats=final.stats,
        ts=t_eval if use_dense else None,
        ys=final.out_ys if use_dense else None,
        event_t=final.ev["event_t"] if specs else None,
        event_y=final.ev["event_y"] if specs else None,
        event_idx=final.ev["event_idx"] if specs else None,
        sens=final.yd if use_sens else None,
        quad=(final.q_acc[:, 0] if quad_scalar else final.q_acc)
        if use_quad else None,
        mesh=final.mesh if _mesh_size else None,
        h_next=final.h,
    )
