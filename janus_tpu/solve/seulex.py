"""Batched SEULEX: semi-implicit Euler + polynomial extrapolation, at full
reference depth.

The reference's primary Python solver (src/python/seulexted.py, 1396 lines —
the Numerical Recipes StepperSie algorithm batched over masks): KMAXX=13
subdivision ladder nseq = 2,3,4,6,8,12,... (nseq[i] = 2*nseq[i-2],
seulexted.py:62-65), work-model cost ladder (costjac=5, costlu=costfunc=
costsolve=1, :53-79), theta-gated Jacobian reuse (jac_redo = min(1e-4, rtol),
refresh only when the stability-check theta exceeds it, :59,328), the
stability check on the first substep of levels k<=1 (:1020-1334), and the
STEPFAC/KFAC order-window controller (:245-251).

Batched re-design (one step ATTEMPT per lax.while_loop body, house lockstep
style):

- the ladder is a STATIC Python loop over levels, each gated by ``lax.cond``
  on ``any(lane still needs it)`` — the lockstep analogue of the sequential
  compute-to-k_targ loop with its data-dependent breaks; per-lane `decided`
  masks carry the NR break/continue semantics (converged at k_targ-1/k_targ/
  k_targ+1, divergence abort, stability abort);
- each level: ONE LU of (M/h' − J) reused across its nseq[k] semi-implicit
  Euler substeps (run under ``lax.fori_loop``), then Aitken–Neville
  extrapolation; per-lane theta from the k<=1 stability check persists in
  state and gates the next Jacobian refresh;
- order targeting: per-lane hopt[k]/work[k] arrays and the NR kopt selection
  (work-ratio tests with KFAC1=0.7/KFAC2=0.9) via one-hot picks — no gathers;
- mass matrix: substeps solve (M/h' − J) d = f (index-1 DAE form);
- dense output/events: extrapolation-consistent (the reference's fsave/dens
  role, seulex_batch.py:24-26) — a parallel Aitken–Neville table of the
  step-MIDPOINT substep values over the even-nseq levels yields an
  extrapolated y(t+h/2) at the ladder's own accuracy; the interpolant is
  then the quartic through (y0, f0, ymid, y1, f1) (error O(h^5) + midpoint
  data error O(h^k), tracking the solve instead of plateauing at cubic-
  Hermite O(h^4)). With a mass matrix: quadratic through (y0, ymid, y1)
  (f is not y' on algebraic rows). Lanes accepting at levels k < 2 keep the
  cubic-Hermite/linear fallback. The two extra f-evals are gated on
  ``any(accept)`` and counted in nfev.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp
import numpy as np

from janus_tpu import config
from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok
from janus_tpu.solve import common as cm
from janus_tpu.solve.events import (handle_events, init_event_state,
                                    normalize_events)
from janus_tpu.solve.options import Options
from janus_tpu.solve.radau import default_jacobian

_EINSUM_PRECISION = jax.lax.Precision.HIGHEST

# NR StepperSie controller constants (reference seulexted.py:245-251)
STEPFAC1 = 0.65
STEPFAC2 = 0.94
STEPFAC3 = 0.02
STEPFAC4 = 4.0
STEPFAC5 = 0.5
KFAC1 = 0.7
KFAC2 = 0.9
# work model (reference seulexted.py:53-56)
COST_FUNC = 1.0
COST_JAC = 5.0
COST_LU = 1.0
COST_SOLVE = 1.0

# quartic dense-output solve: given a0 = y0, a1 = h·f0, the remaining
# coefficients satisfy  [[1,1,1],[2,3,4],[1/4,1/8,1/16]]·[a2,a3,a4] =
# [y1−y0−a1, h·f1−a1, ymid−y0−a1/2]
_QI = np.linalg.inv(np.array([[1.0, 1.0, 1.0],
                              [2.0, 3.0, 4.0],
                              [0.25, 0.125, 0.0625]]))


def _nseq(kmax: int):
    """Subdivision ladder: 2, 3, 4, 6, 8, 12, ... (nseq[i] = 2*nseq[i-2])."""
    ns = [2, 3]
    for i in range(2, kmax + 1):
        ns.append(2 * ns[i - 2])
    return ns


def _pick(arr, idx):
    """arr[:, idx] with per-lane idx via one-hot (no gather). arr: [M, K]."""
    oh = (idx[:, None] == jnp.arange(arr.shape[1])[None, :]).astype(arr.dtype)
    return jnp.sum(oh * arr, axis=1)


@struct.dataclass
class _SxState:
    t: jnp.ndarray
    y: jnp.ndarray
    h: jnp.ndarray
    k_targ: jnp.ndarray       # [M] target level
    theta: jnp.ndarray        # [M] last stability-check contraction measure
    jac: jnp.ndarray          # [M, D, D]
    calcjac: jnp.ndarray      # [M] Jacobian is fresh for this step point
    first: jnp.ndarray        # [M] no step accepted yet
    rejected: jnp.ndarray     # [M] previous attempt was rejected
    nbad: jnp.ndarray         # [M] consecutive rejections (stall guard)
    yd: jnp.ndarray           # [K, M, D] IND tangent directions (K=0 off)
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any
    ev: Any
    q_acc: Any                # [M, Q] running-cost quadrature (0-d unused)
    mesh: Any                 # accepted-step rings (dense= interpolation)


def solve_seulex(f: Callable, t0, tf, y0, args=None,
                 options: Optional[Options] = None, t_eval=None,
                 jac: Optional[Callable] = None, mass=None,
                 events=None, tangents=None,
                 args_tangents=None,
                 quad: Optional[Callable] = None,
                 dense: int = 0, step_args=None,
                 _mesh_size: int = 0, _h0=None,
                 _force_jac: bool = False) -> cm.Solution:
    """Batched adaptive SEULEX solve (extrapolated linearly implicit Euler).

    _mesh_size / _h0 / _force_jac are internal (solve/adjoint_seulex.py):
    record (t, h, y, accepted level k) rings for the discrete adjoint's
    frozen-mesh step replay; warm-start the per-lane initial step for
    segment chaining; and refresh the Jacobian at EVERY new step point
    (ignoring the theta gate) so the replay's fresh ``jac_fn(t_n, y_n)``
    reproduces the forward iteration matrices bit-for-bit.

    dense: step-mesh capacity N > 0: store each accepted step's
    extrapolation-consistent interpolant (the quartic / cubic-Hermite /
    quadratic of the module docstring, expanded into the shared power basis
    y_k + Σ_p θ^{p+1}·q_k[p]) so ``Solution.interpolate(ts)`` evaluates the
    solution anywhere post hoc (scipy's ``sol.sol(t)`` role). Size N above
    the worst lane's step count; overflowing lanes interpolate to NaN.

    quad: optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
    (or ``[M, Q]``); ``Solution.quad`` = ∫ l dt accumulated per accepted
    step by 3-point Gauss-Legendre on the extrapolation-consistent dense
    interpolant (the quartic through (y0, f0, ymid, y1, f1); the
    lower-order quadratic with a mass matrix). Event-terminated lanes
    integrate only to t*. The CVODES quadrature-integration role on the
    extrapolation family.

    tangents / args_tangents: first-class internal-differentiation forward
    sensitivities — the reference's SeulexTed dual architecture
    (src/python/seulexted.py: every state a TensorDual). K seed directions
    ([K, M, D] and/or args-pytree leaves with leading K) propagate through
    the SAME ladder: each level's linearly implicit Euler substeps apply the
    step's ONE LU to the variational rhs (J(t_n, y_n)·δ + f_θ·dθ, one
    ``jax.linearize`` per substep, no Jacobians materialized) and the
    tangent rows extrapolate through the same Aitken–Neville table. Because
    the semi-implicit Euler is a W-method — its h-expansion exists for ANY
    iteration matrix — the tangent ladder extrapolates to the variational
    flow at the ladder's own order even though ∂A/∂y is dropped. Returned
    in ``Solution.sens`` [K, M, D]; terminal mode only (t_eval/events with
    tangents raise — use jax.jvp there).
    """
    opts = options if options is not None else Options()
    use_pallas = config.use_stage_lu_kernel(opts)
    if opts.nind2 or opts.nind3:
        raise ValueError("Options.nind2/nind3 (higher-index DAE error "
                         "weighting) is honored by 'radau'/'radaup' only; "
                         "seulex would silently integrate with wrong weights")
    specs = normalize_events(events)
    store_q = bool(dense)
    mesh_size = max(int(_mesh_size), int(dense))
    store_mesh = bool(mesh_size)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    jac_fn = jac if jac is not None else default_jacobian(f)

    use_slabs = step_args is not None
    if use_slabs:
        # the reference's nparams_step (seulexted.py:13-27, 326-370): every
        # f/jac evaluation of a lane's k-th accepted-step ATTEMPT (all
        # ladder levels) uses slab row k, passed as f(t, y, (args, slab_k))
        if tangents is not None or args_tangents is not None:
            raise ValueError("step_args= does not compose with tangents= "
                             "(slab rows are step-indexed; seed the slab "
                             "table directly via jax.jvp instead)")
        if _mesh_size:
            raise ValueError("step_args= does not compose with the discrete "
                             "adjoint (the replay has no slab index); use "
                             "time-indexed controls for reverse mode")
        n_slabs, slab_at = cm.make_slab_selector(step_args, m, dtype)

    use_sens = tangents is not None or args_tangents is not None
    if use_sens and (t_eval is not None or events is not None):
        raise ValueError("solve_seulex(tangents=) is terminal-mode only "
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
        yd0 = jnp.zeros((0, m, dim), dtype)
        k_dirs = 0

    kmax = opts.seulex_kmax               # KMAXX; levels 0..kmax run
    K = kmax + 1                          # IMAXX
    NSEQ = _nseq(kmax)
    jac_redo = min(1.0e-4, opts.rtol)

    # cumulative work ladder (reference seulexted.py:66-79)
    cost_np = np.zeros(K)
    cost_np[0] = COST_JAC + COST_LU + NSEQ[0] * (COST_FUNC + COST_SOLVE)
    for k in range(kmax):
        cost_np[k + 1] = (cost_np[k] + (NSEQ[k + 1] - 1)
                          * (COST_FUNC + COST_SOLVE) + COST_LU)
    cost = jnp.asarray(cost_np, dtype)
    nseq_f = jnp.asarray(np.asarray(NSEQ, dtype=float), dtype)

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
        # per-lane warm-start step (segment chaining, solve/adjoint_seulex):
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

    # tolerance-derived initial target order (reference seulexted.py:83-87)
    logfact = -np.log10(opts.rtol + opts.atol) * 0.6 + 0.5
    kt0 = int(np.clip(round(logfact), 1, kmax - 1))

    stats = cm.zero_stats(m, ("nfev", "njev", "nlu", "nsteps", "naccept",
                              "nreject", "order"))
    stats["nfev"] = stats["nfev"] + 2
    already_done = t0 == tf
    state = _SxState(
        t=t0, y=y0, h=h,
        k_targ=jnp.full((m,), kt0, jnp.int32),
        theta=jnp.full((m,), 2.0 * jac_redo, dtype),
        jac=jnp.zeros((m, dim, dim), dtype),
        calcjac=jnp.zeros((m,), bool),
        first=jnp.ones((m,), bool),
        rejected=jnp.zeros((m,), bool),
        nbad=jnp.zeros((m,), jnp.int32),
        yd=yd0,
        active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys,
        ev=init_event_state(specs, m, dim, t0, y0, args, dtype),
        q_acc=q_acc0,
        mesh=(
            {"t": jnp.zeros((m, mesh_size), dtype),
             "h": jnp.zeros((m, mesh_size), dtype),
             "y": jnp.zeros((m, mesh_size, dim), dtype),
             "k": jnp.zeros((m, mesh_size), jnp.int32),
             **({"q": jnp.zeros((m, mesh_size, 4, dim), dtype)}
                if store_q else {})}
            if store_mesh else {}),
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
        h_abs = jnp.abs(h)
        scale = opts.atol + opts.rtol * jnp.abs(st.y)

        if use_slabs:
            # a lane's k-th accepted-step attempt (all ladder levels) runs
            # on slab row k (the reference's nparams_step semantics)
            exhausted = st.active & (st.stats["naccept"] >= n_slabs)
            fa = (args, slab_at(st.stats["naccept"]))
        else:
            exhausted = jnp.zeros((m,), bool)
            fa = args

        # ---- theta-gated Jacobian refresh (reference :328) ----------------
        # _force_jac (adjoint recording): every NEW step point refreshes, so
        # the replay's fresh jac_fn(t_n, y_n) is the forward matrix exactly
        if _force_jac:
            needj = st.active & ~st.calcjac
        else:
            needj = st.active & (st.theta > jac_redo) & ~st.calcjac

        def do_jac(_):
            jn = jac_fn(st.t, st.y, fa)
            return jnp.where(needj[:, None, None], jn, st.jac)

        jmat = jax.lax.cond(jnp.any(needj), do_jac, lambda _: st.jac, None)
        calcjac = st.calcjac | needj

        # ---- the gated extrapolation ladder -------------------------------
        decided = ~st.active
        accept = jnp.zeros((m,), bool)
        reject_h = jnp.zeros((m,), bool)     # halve-h rejects (stab/diverge)
        abort = jnp.zeros((m,), bool)        # NR retarget-aborts
        abort_p1 = jnp.zeros((m,), bool)     # abort at k_targ+1
        y_acc = st.y
        k_dec = jnp.zeros((m,), jnp.int32)
        errold = jnp.zeros((m,), dtype)
        theta_new = st.theta
        nfev_add = jnp.zeros((m,), jnp.int32)
        nlu_add = jnp.zeros((m,), jnp.int32)
        hopt_cols = [h_abs]                  # level 0 placeholder
        work_cols = [jnp.full((m,), jnp.inf, dtype)]
        rows = []
        # extrapolation-consistent dense output (the reference keeps
        # fsave/dens arrays, seulex_batch.py:24-26): a PARALLEL Neville
        # table of the step-midpoint substep values over the even-nseq
        # levels; the accepted lane's extrapolated midpoint feeds a quartic
        # interpolant whose accuracy tracks the ladder instead of
        # plateauing at cubic-Hermite O(h^4)
        rows_mid = []
        even_nseq = []
        ymid_acc = st.y
        mid_ok = jnp.zeros((m,), bool)
        rows_d = []                          # tangent Aitken-Neville table
        yd_acc = st.yd

        for k in range(K):
            nj = NSEQ[k]
            need = st.active & ~decided & (k <= st.k_targ + 1)

            def run_level(_, k=k, nj=nj):
                hsub = h / nj
                mm = eye[None] if mass is None else (
                    mass[None] if mass.ndim == 2 else mass)
                amat = mm / hsub[:, None, None] - jmat
                if use_pallas:
                    from janus_tpu.ops import lu_solve as kernel_solve
                    from janus_tpu.solve.radau import _pallas_lu_factor
                    lu, piv = _pallas_lu_factor(amat)
                    lu_solve_l = lambda l, p, b: kernel_solve(l, b)  # noqa: E731
                else:
                    lu, piv = lu_factor(amat, pivot=opts.pivoting)
                    lu_solve_l = lu_solve
                ok = lu_ok(lu)
                x1 = st.t + hsub

                def var_rhs(ti, yi, dys):
                    # variational forcing J(ti, yi)·δ_k + f_θ·dθ_k for all K
                    # directions from ONE linearization (no J materialized)
                    if args_d is None:
                        _, lin = jax.linearize(
                            lambda yy: f(ti, yy, args), yi)
                        return jnp.stack([lin(dys[q])
                                          for q in range(k_dirs)])
                    _, lin = jax.linearize(
                        lambda yy, aa: f(ti, yy, aa), yi, args)
                    return jnp.stack([lin(dys[q], args_d_rows[q])
                                      for q in range(k_dirs)])

                def solve_k(rhs):              # [K, M, D] -> [K, M, D]
                    return jax.vmap(lambda b: lu_solve_l(lu, piv, b))(rhs)

                d = lu_solve_l(lu, piv, f(x1, st.y, fa))
                ytemp = st.y
                theta_k = jnp.full((m,), -1.0, dtype)
                if use_sens:
                    # tangent substeps mirror the primal exactly: the ONE LU
                    # applies to the variational rhs (module docstring)
                    dd_s = solve_k(var_rhs(x1, st.y, st.yd))
                    yd_t = st.yd + dd_s
                else:
                    yd_t = st.yd
                    dd_s = st.yd
                # first substep explicitly (stability check for k <= 1)
                ytemp = ytemp + d
                fy1 = f(st.t + 2.0 * hsub, ytemp, fa)
                if k <= 1:
                    del1 = cm.safe_sqrt(jnp.mean(jnp.square(d / scale), axis=-1))
                    dytemp = f(x1, ytemp, fa)
                    dd = dytemp - mdot(d) / hsub[:, None]
                    d2v = lu_solve_l(lu, piv, dd)
                    del2 = cm.safe_sqrt(jnp.mean(jnp.square(d2v / scale),
                                             axis=-1))
                    theta_k = del2 / jnp.maximum(1.0, del1)
                    theta_k = jnp.where(jnp.isfinite(theta_k), theta_k, 2.0)
                    ok = ok & (theta_k <= 1.0)
                d = lu_solve_l(lu, piv, fy1)
                if use_sens:
                    dd_s = solve_k(var_rhs(st.t + 2.0 * hsub, ytemp, yd_t))
                ymid0 = ytemp          # after 1 substep == the nj=2 midpoint

                def sub(nn, carry):
                    yt, dd, ym, ydc, dds = carry
                    yt = yt + dd
                    # capture the step-midpoint substep (even nj only)
                    ym = jnp.where(nn == nj // 2, yt, ym)
                    rhs = f(st.t + (nn + 1.0) * hsub, yt, fa)
                    if use_sens:
                        ydc = ydc + dds
                        dds = solve_k(var_rhs(st.t + (nn + 1.0) * hsub, yt,
                                              ydc))
                    return yt, lu_solve_l(lu, piv, rhs), ym, ydc, dds

                ytemp, d, ymid, yd_t, dd_s = jax.lax.fori_loop(
                    2, nj, sub, (ytemp, d, ymid0, yd_t, dd_s))
                yk = ytemp + d
                ydk = yd_t + dd_s if use_sens else yd_t
                ok = ok & jnp.all(jnp.isfinite(yk), axis=-1)
                return yk, ok, theta_k, ymid, ydk

            def skip_level(_):
                return (jnp.zeros((m, dim), dtype), jnp.ones((m,), bool),
                        jnp.full((m,), -1.0, dtype),
                        jnp.zeros((m, dim), dtype),
                        jnp.zeros((k_dirs, m, dim), dtype))

            yk, okk, theta_k, ymid_k, ydk = jax.lax.cond(
                jnp.any(need), run_level, skip_level, None)
            if k <= 1:
                theta_new = jnp.where(need & (theta_k >= 0.0), theta_k,
                                      theta_new)
            nfev_add = nfev_add + need * (nj + (1 if k <= 1 else 0)
                                          + (nj if use_sens else 0))
            nlu_add = nlu_add + need

            stab_fail = need & ~okk
            reject_h = reject_h | stab_fail
            decided = decided | stab_fail
            k_dec = jnp.where(stab_fail, k, k_dec)

            # Aitken-Neville row (reference extrapolate, :1376)
            row = [yk]
            row_d = [ydk]
            for j in range(k):
                ratio = NSEQ[k] / NSEQ[k - j - 1]
                row.append(row[j] + (row[j] - rows[k - 1][j])
                           / (ratio - 1.0))
                if use_sens:
                    row_d.append(row_d[j] + (row_d[j] - rows_d[k - 1][j])
                                 / (ratio - 1.0))
            rows.append(row)
            rows_d.append(row_d)
            if nj % 2 == 0:
                rowm = [ymid_k]
                for j in range(len(rows_mid)):
                    ratio = nj / even_nseq[len(even_nseq) - 1 - j]
                    rowm.append(rowm[j] + (rowm[j] - rows_mid[-1][j])
                                / (ratio - 1.0))
                rows_mid.append(rowm)
                even_nseq.append(nj)

            if k >= 1:
                live = need & ~stab_fail
                diff = row[k] - row[k - 1]
                err_k = cm.safe_sqrt(jnp.mean(jnp.square(diff / scale), axis=-1))
                err_k = jnp.where(jnp.isfinite(err_k), err_k, 1e10)
                err_k = jnp.maximum(err_k, 1e-18)

                div = live & ((err_k > 1.0 / eps)
                              | ((k > 1) & (err_k >= errold)))
                reject_h = reject_h | div
                decided = decided | div
                k_dec = jnp.where(div, k, k_dec)
                errold = jnp.where(live, jnp.maximum(4.0 * err_k, 1.0),
                                   errold)
                live = live & ~div

                # per-level step proposal + work (NR STEPFAC controller)
                expo = 1.0 / (k + 1.0)
                facmin = STEPFAC3 ** expo
                fac = jnp.where(
                    err_k == 0.0, 1.0 / facmin,
                    jnp.clip(STEPFAC2 / (err_k / STEPFAC1) ** expo,
                             facmin / STEPFAC4, 1.0 / facmin))
                hopt_k = h_abs * fac
                work_k = cost[k] / hopt_k
                hopt_cols.append(jnp.where(live, hopt_k, h_abs))
                work_cols.append(jnp.where(live, work_k, jnp.inf))

                # convergence / abort windows around k_targ
                is_m1 = k == (st.k_targ - 1)
                is_t = k == st.k_targ
                is_p1 = k == (st.k_targ + 1)
                fl = st.first | last
                small = err_k <= 1.0
                conv = live & small & (fl
                                       | (is_m1 & ~st.rejected & ~fl)
                                       | is_t | is_p1)
                accept = accept | conv
                decided = decided | conv
                y_acc = jnp.where(conv[:, None], row[k], y_acc)
                if use_sens:
                    yd_acc = jnp.where(conv[None, :, None], row_d[k], yd_acc)
                if nj % 2 == 0:
                    ymid_acc = jnp.where(conv[:, None], rows_mid[-1][-1],
                                         ymid_acc)
                    # level 0/1 midpoints are too raw; quartic needs k >= 2
                    mid_ok = mid_ok | (conv & (k >= 2))
                k_dec = jnp.where(conv, k, k_dec)
                live = live & ~conv

                ab_m1 = (live & is_m1 & ~st.rejected & ~fl
                         & (err_k > 4.0 * nseq_f[min(k + 1, K - 1)]
                            * nseq_f[min(k + 2, K - 1)]))
                ab_t = live & is_t & (err_k > 2.0 * nseq_f[min(k + 1, K - 1)])
                ab_p1 = live & is_p1 & (err_k > 1.0)
                abort = abort | ab_m1 | ab_t
                abort_p1 = abort_p1 | ab_p1
                decided = decided | ab_m1 | ab_t | ab_p1
                k_dec = jnp.where(ab_m1 | ab_t | ab_p1, k, k_dec)

        # exhausted step_args lanes may not advance (the reference throws
        # BEFORE such a step; here the lane fails with PARAMS_EXHAUSTED)
        accept = accept & ~exhausted

        # lanes that ran out of ladder without deciding: treat as reject
        leftover = st.active & ~decided
        reject_h = reject_h | leftover
        k_dec = jnp.where(leftover, jnp.minimum(st.k_targ + 1, kmax), k_dec)

        H = jnp.stack(hopt_cols, axis=1)      # [M, K']
        W = jnp.stack(work_cols, axis=1)
        reject = reject_h | abort | abort_p1

        # ---- NR retarget on aborts ---------------------------------------
        w_k = _pick(W, k_dec)
        w_km1 = _pick(W, jnp.maximum(k_dec - 1, 0))
        kt_ab = jnp.where((k_dec > 1) & (w_km1 < KFAC1 * w_k),
                          k_dec - 1, k_dec)
        w_t = _pick(W, st.k_targ)
        w_tm1 = _pick(W, jnp.maximum(st.k_targ - 1, 0))
        kt_p1 = jnp.where((st.k_targ > 1) & (w_tm1 < KFAC1 * w_t),
                          st.k_targ - 1, st.k_targ)
        kt_rej = jnp.where(abort, kt_ab, jnp.where(abort_p1, kt_p1,
                                                   st.k_targ))
        kt_rej = jnp.clip(kt_rej, 1, kmax - 1)
        h_rej = jnp.where(abort | abort_p1, _pick(H, kt_rej),
                          h_abs * STEPFAC5)

        # ---- NR kopt selection on accepts --------------------------------
        kk = k_dec
        w_kk = _pick(W, kk)
        w_kkm1 = _pick(W, jnp.maximum(kk - 1, 0))
        w_kkm2 = _pick(W, jnp.maximum(kk - 2, 0))
        # k <= k_targ branch
        kopt_a = jnp.where(w_kkm1 < KFAC1 * w_kk, kk - 1,
                           jnp.where(w_kk < KFAC2 * w_kkm1,
                                     jnp.minimum(kk + 1, kmax - 1), kk))
        # k == k_targ+1 branch
        kopt_b0 = jnp.where((kk > 2) & (w_kkm2 < KFAC1 * w_kkm1),
                            kk - 2, kk - 1)
        w_koptb0 = _pick(W, jnp.clip(kopt_b0, 0, kmax))
        kopt_b = jnp.where(w_kk < KFAC2 * w_koptb0,
                           jnp.minimum(kk, kmax - 1), kopt_b0)
        kopt = jnp.where(kk == 1,
                         jnp.where(st.rejected, 1, 2),
                         jnp.where(kk <= st.k_targ, kopt_a, kopt_b))
        kopt = jnp.clip(kopt, 1, kmax - 1)

        h_kopt = _pick(H, kopt)
        h_kk = _pick(H, kk)
        # NR ms521 growth: when converging below target with cheap work,
        # kopt = k+1 and hnew = hopt[k]·cost[kopt+1]/cost[k] (= cost[k+2])
        cost_kp2 = _pick(jnp.broadcast_to(cost[None, :], (m, K)),
                         jnp.minimum(kk + 2, kmax))
        cost_kk = _pick(jnp.broadcast_to(cost[None, :], (m, K)), kk)
        cost_kopt = _pick(jnp.broadcast_to(cost[None, :], (m, K)), kopt)
        h_grow = jnp.where((kk < st.k_targ) & (w_kk < KFAC2 * w_kkm1),
                           h_kk * cost_kp2 / cost_kk,
                           h_kk * cost_kopt / cost_kk)
        kt_acc = jnp.where(st.rejected, jnp.minimum(kopt, kk), kopt)
        h_acc = jnp.where(st.rejected,
                          jnp.minimum(h_abs, _pick(H, jnp.clip(kt_acc, 0,
                                                               kmax))),
                          jnp.where(kopt <= kk, h_kopt, h_grow))

        k_targ_new = jnp.where(accept, jnp.clip(kt_acc, 1, kmax - 1),
                               jnp.where(reject, kt_rej, st.k_targ))
        h_next_abs = jnp.where(accept, h_acc,
                               jnp.where(reject, h_rej, h_abs))
        h_next_abs = jnp.minimum(jnp.maximum(h_next_abs, 1e-30),
                                 opts.max_step)
        h_next = jnp.where(st.active, h_next_abs * jnp.sign(h), st.h)

        # ---- dense output & events (gated; see module docstring) ---------
        t_new = st.t + h
        y_new = y_acc
        out_ys = st.out_ys
        interp = None
        nfev_interp = jnp.zeros((m,), jnp.int32)
        if use_dense or specs or use_quad or store_q:
            def build_interp(_):
                return f(t_new, y_new, fa), f(st.t, st.y, fa)

            def skip_interp(_):
                z = jnp.zeros((m, dim), dtype)
                return z, z

            fn, fy = jax.lax.cond(jnp.any(accept), build_interp, skip_interp,
                                  None)
            nfev_interp = accept * 2
            hcol = h[:, None]

            def interp(theta):
                th = theta[..., None]
                if mass is not None:
                    # algebraic rows make f != y' — but the extrapolated
                    # midpoint still gives a quadratic through
                    # (y0, ymid, y1); linear when no midpoint is available
                    lin = (1 - th) * st.y[:, None] + th * y_new[:, None]
                    a1 = 4 * ymid_acc - y_new - 3 * st.y
                    a2 = 2 * y_new + 2 * st.y - 4 * ymid_acc
                    quad = (st.y[:, None] + a1[:, None] * th
                            + a2[:, None] * th * th)
                    return jnp.where(mid_ok[:, None, None], quad, lin)
                h00 = (1 + 2 * th) * (1 - th) ** 2
                h10 = th * (1 - th) ** 2
                h01 = th * th * (3 - 2 * th)
                h11 = th * th * (th - 1)
                cubic = (h00 * st.y[:, None]
                         + h10 * hcol[:, None] * fy[:, None]
                         + h01 * y_new[:, None]
                         + h11 * hcol[:, None] * fn[:, None])
                # quartic through (y0, f0, ymid, y1, f1): interpolation
                # error O(h^5) with midpoint data at the ladder's accuracy
                b1 = hcol * fy
                r1 = y_new - st.y - b1
                r2 = hcol * fn - b1
                r3 = ymid_acc - st.y - 0.5 * b1
                a2 = (_QI[0, 0] * r1 + _QI[0, 1] * r2 + _QI[0, 2] * r3)
                a3 = (_QI[1, 0] * r1 + _QI[1, 1] * r2 + _QI[1, 2] * r3)
                a4 = (_QI[2, 0] * r1 + _QI[2, 1] * r2 + _QI[2, 2] * r3)
                quart = (st.y[:, None] + b1[:, None] * th
                         + a2[:, None] * th ** 2 + a3[:, None] * th ** 3
                         + a4[:, None] * th ** 4)
                return jnp.where(mid_ok[:, None, None], quart, cubic)

        if store_mesh:
            # where, not accept*: finished lanes can carry non-finite stage
            # values and 0·NaN poisons dead slots the one-hot sum touches
            rows_sc = jnp.arange(m)
            idx = st.stats["naccept"]
            mesh = {
                "t": st.mesh["t"].at[rows_sc, idx].add(
                    jnp.where(accept, st.t, 0.0), mode="drop"),
                "h": st.mesh["h"].at[rows_sc, idx].add(
                    jnp.where(accept, h, 0.0), mode="drop"),
                "y": st.mesh["y"].at[rows_sc, idx].add(
                    jnp.where(accept[:, None], st.y, 0.0), mode="drop"),
                "k": st.mesh["k"].at[rows_sc, idx].add(
                    jnp.where(accept, k_dec, 0), mode="drop"),
            }
        else:
            mesh = st.mesh
        if store_q:
            # the same interpolants expanded into the shared power basis
            # y0 + Σ_p θ^{p+1}·q[p] (Solution.interpolate's contract)
            if mass is not None:
                a1q = 4 * ymid_acc - y_new - 3 * st.y
                a2q = 2 * y_new + 2 * st.y - 4 * ymid_acc
                zero = jnp.zeros((m, dim), dtype)
                q_hi = jnp.stack([a1q, a2q, zero, zero], axis=1)
                q_lo = jnp.stack([y_new - st.y, zero, zero, zero], axis=1)
            else:
                b1 = h[:, None] * fy
                r1 = y_new - st.y - b1
                r2 = h[:, None] * fn - b1
                r3 = ymid_acc - st.y - 0.5 * b1
                a2 = _QI[0, 0] * r1 + _QI[0, 1] * r2 + _QI[0, 2] * r3
                a3 = _QI[1, 0] * r1 + _QI[1, 1] * r2 + _QI[1, 2] * r3
                a4 = _QI[2, 0] * r1 + _QI[2, 1] * r2 + _QI[2, 2] * r3
                q_hi = jnp.stack([b1, a2, a3, a4], axis=1)
                # cubic Hermite (no trusted midpoint) in the power basis
                hf1 = h[:, None] * fn
                q_lo = jnp.stack(
                    [b1,
                     3.0 * (y_new - st.y) - 2.0 * b1 - hf1,
                     -2.0 * (y_new - st.y) + b1 + hf1,
                     jnp.zeros((m, dim), dtype)], axis=1)
            q_step = jnp.where(mid_ok[:, None, None], q_hi, q_lo)
            mesh["q"] = st.mesh["q"].at[rows_sc, idx].add(
                jnp.where(accept[:, None, None], q_step, 0.0), mode="drop")

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

        # ---- bookkeeping --------------------------------------------------
        done = accept & last

        stats = dict(st.stats)
        stats["nfev"] = stats["nfev"] + nfev_add + nfev_interp
        stats["njev"] = stats["njev"] + needj
        stats["nlu"] = stats["nlu"] + nlu_add
        stats["nsteps"] = stats["nsteps"] + st.active
        stats["naccept"] = stats["naccept"] + accept
        stats["nreject"] = stats["nreject"] + reject
        stats["order"] = jnp.where(st.active, k_targ_new + 1, stats["order"])

        nbad = jnp.where(reject, st.nbad + 1, jnp.where(accept, 0, st.nbad))
        stall = st.active & (nbad >= 20)
        exceeded = st.active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test
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

        return _SxState(
            t=jnp.where(accept, jnp.where(terminate, t_ev, t_new), st.t),
            y=jnp.where(accept[:, None],
                        jnp.where(terminate[:, None], y_ev, y_new), st.y),
            h=h_next,
            k_targ=k_targ_new,
            theta=theta_new,
            jac=jmat,
            # a fresh step point invalidates the Jacobian; rejects keep it
            calcjac=jnp.where(accept, False, calcjac),
            first=jnp.where(accept, False, st.first),
            rejected=jnp.where(accept, False, st.rejected | reject),
            nbad=nbad,
            yd=jnp.where(accept[None, :, None], yd_acc, st.yd),
            active=active, status=status, stats=stats, out_ys=out_ys,
            ev=ev, q_acc=q_acc, mesh=mesh,
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
        mesh=final.mesh if store_mesh else None,
        h_next=final.h,
    )
