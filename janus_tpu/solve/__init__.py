"""Lockstep masked adaptive steppers (pure functions under lax.while_loop)."""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu.solve.common import (
    Solution,
    RUNNING,
    SUCCESS,
    MAX_STEPS,
    STEP_UNDERFLOW,
    NEWTON_STALL,
    EVENT_TERMINATED,
    PARAMS_EXHAUSTED,
)
from janus_tpu.solve.options import Options

# method -> feature support matrix (mirrored in README.md). solve_ivp RAISES
# on an unsupported feature instead of silently dropping it (the reference's
# single entry point role: odesolvers/common_integrator.py:21-33).
FEATURES = {
    #                jac    mass   events t_eval
    "dopri5":       (False, False, True,  True),
    "dopri853":     (False, False, True,  True),
    "radau":        (True,  True,  True,  True),
    "radaup":       (True,  True,  True,  True),
    "bdf":          (True,  True,  True,  True),
    "bdf2":         (True,  False, False, True),   # LEGACY: subsumed by bdf
    "seulex":       (True,  True,  True,  True),
    "rodas":        (True,  True,  True,  True),
    "grk4t":        (True,  False, False, True),   # LEGACY: subsumed by rodas
}

# methods whose stage LU can run the Pallas kernel (Options.pallas_lu)
_KERNEL_LU_METHODS = ("radau", "rodas", "bdf", "seulex")

_ALIASES = {
    "rk45": "dopri5", "dop853": "dopri853",
    "radau5": "radau", "radau9": "radau", "radau13": "radau",
    "ndf": "bdf", "bdf_classic": "bdf",
    "ros4": "grk4t", "rosenbrock": "grk4t",
}


def _check_features(method: str, jac, mass, events, t_eval):
    sup_jac, sup_mass, sup_events, sup_teval = FEATURES[method]
    if jac is not None and not sup_jac:
        raise ValueError(f"method {method!r} does not use a Jacobian "
                         "(explicit method); drop jac= or pick a stiff solver")
    if mass is not None and not sup_mass:
        raise ValueError(f"method {method!r} does not support a mass matrix; "
                         "use method='radau', 'radaup', 'seulex', 'rodas' "
                         "or 'bdf' (invertible mass only)")
    if events is not None and not sup_events:
        raise ValueError(f"method {method!r} does not support events; "
                         "use 'dopri5', 'dopri853', 'radau', 'radaup', "
                         "'bdf', 'seulex' or 'rodas'")
    if t_eval is not None and not sup_teval:
        raise ValueError(f"method {method!r} does not support t_eval")


def solve_ivp(f: Callable, tspan, y0, method: str = "dopri5", args: Any = None,
              options: Optional[Options] = None, t_eval=None,
              events=None, jac: Optional[Callable] = None, mass=None,
              tangents=None, args_tangents=None,
              quad: Optional[Callable] = None, dense: int = 0,
              step_args: Any = None,
              **opt_kw) -> Solution:
    """Batched initial-value-problem solve.

    f       : batched RHS ``f(t[M], y[M,D], args) -> [M,D]``
    tspan   : (t0, tf); either may be scalar or [M] (reverse time = tf < t0)
    y0      : [M, D] (or [D] for a single trajectory)
    method  : 'dopri5' | 'dopri853'                  (explicit, PI control)
              'radau' | 'radau5'/'radau9'/'radau13'  (Radau IIA, fixed order)
              'radaup'                               (per-lane variable order)
              'bdf'                                  (variable-order NDF 1-5)
              'bdf_classic'                          (same, classical BDF
                                                      error constants)
              'bdf2' | 'seulex'                      (BDF2 / extrapolation)
              'rodas' | 'grk4t'                      (Rosenbrock: RODAS4 /
                                                      Kaps-Rentrop GRK4T)
    options : Options(...); or pass rtol=…, atol=… etc. as keywords
    t_eval  : optional shared output grid [T] (dense-output sampling)
    events  : optional event functions (see solve.events)
    jac     : optional analytic Jacobian ``jac(t, y, args) -> [M,D,D]``
              (implicit methods; default: forward-mode AD)
    mass    : optional mass matrix [D,D] or [M,D,D] (DAE form M·y' = f)
    tangents: optional [K, M, D] seed directions — first-class forward
              sensitivities by internal differentiation (radau fixed-stage
              AND the variable-order ladder, both composing with
              t_eval/events; seulex/rodas/bdf in terminal mode; returned
              in Solution.sens; reuses each step's LU factors).
              Any method also differentiates via jax.jvp.
    quad    : optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
              or ``[M, Q]``; ``Solution.quad`` = ∫ l dt accumulated at the
              solve's own order (the CVODES quadrature-integration role).
              Fixed-stage radau uses the collocation-weight rule and with
              ``tangents=`` also fills ``Solution.sens_quad``; rodas and
              seulex integrate by Gauss-Legendre on their dense
              interpolants. For reverse-mode gradients of integral costs
              use ``radau_adjoint(cost=...)``.
    step_args: optional pytree of per-ACCEPTED-step parameter slabs
              (the one-step adaptive methods: 'dopri5'/'dopri853'/'seulex'
              — the reference's exact adaptive-stepper theta/nparams_step
              semantics, dopri853ted.hpp:302-308, seulexted.py:326-370 —
              plus 'rodas' and fixed-stage 'radau'): every leaf
              has leading axis S; a lane's k-th accepted step evaluates
              all stages/levels with row k, passed to f as
              ``(args, slab_k)`` (the odeint_fixed convention). Leaves
              with second axis M are per-lane tables. Lanes that need a
              row past S fail with status PARAMS_EXHAUSTED (the
              reference's exhaustion error, per-lane). Prefer
              models.controls time-indexed schedules when the control
              should not be coupled to the mesh the controller picks.
    dense   : step-mesh capacity N > 0 (fixed-stage radau, rodas, seulex):
              store each accepted step's interpolant (collocation
              polynomial / CONTRO cubic / extrapolation quartic) so
              ``Solution.interpolate(ts)`` evaluates the solution anywhere
              post hoc (scipy's dense_output role). Size N above the worst
              lane's step count; overflowing lanes interpolate to NaN.

    Feature support per method is the FEATURES table; unsupported
    combinations raise instead of being silently ignored.
    """
    if options is None:
        options = Options(**opt_kw)
    elif opt_kw:
        options = options.replace(**opt_kw)
    t0, tf = tspan

    method = method.lower()
    canonical = _ALIASES.get(method, method)
    if canonical not in FEATURES:
        raise ValueError(f"unknown method {method!r}; "
                         f"known: {sorted(FEATURES) + sorted(_ALIASES)}")
    _check_features(canonical, jac, mass, events, t_eval)
    if (tangents is not None or args_tangents is not None) \
            and canonical not in ("radau", "radaup", "seulex", "rodas",
                                  "bdf"):
        raise ValueError("tangents= (internal-differentiation sensitivities)"
                         " is supported by the 'radau'/'radaup' methods, "
                         "'seulex', 'rodas' and 'bdf'; use jax.jvp through "
                         "the solve otherwise")
    if quad is not None and canonical not in ("radau", "radaup", "rodas",
                                              "seulex", "dopri5",
                                              "dopri853", "bdf"):
        raise ValueError("quad= (running-cost quadratures) is supported by "
                         "the fixed-stage 'radau' methods (collocation-"
                         "weight rule, incl. sens_quad), 'radaup', 'rodas',"
                         " 'seulex', 'bdf' and 'dopri5'/'dopri853' (Gauss-"
                         "Legendre on the dense interpolant); integrate "
                         "the cost as an extra state otherwise")
    if dense and canonical not in ("radau", "radaup", "rodas", "seulex",
                                   "dopri5", "dopri853", "bdf"):
        raise ValueError("dense= (post-hoc Solution.interpolate) is "
                         "supported by the 'radau'/'radaup' methods, "
                         "'rodas', 'seulex', 'bdf' and "
                         "'dopri5'/'dopri853'; use t_eval= otherwise")

    if options.pallas_lu and canonical not in _KERNEL_LU_METHODS:
        raise ValueError(f"Options(pallas_lu=True) has no effect on method "
                         f"{method!r}; its stage LU kernel serves "
                         f"{_KERNEL_LU_METHODS}")
    if step_args is not None and canonical not in ("dopri5", "dopri853",
                                                   "seulex", "rodas",
                                                   "radau"):
        raise ValueError("step_args= (per-accepted-step parameter slabs, "
                         "the reference's theta/nparams_step semantics) is "
                         "supported by the one-step adaptive methods "
                         "'dopri5'/'dopri853', 'seulex', 'rodas' and "
                         "fixed-stage 'radau' (multistep bdf history "
                         "assumes a smooth f across steps); use "
                         "models.controls time-indexed schedules or "
                         "solve.fixed.odeint_fixed(step_args=) otherwise")
    if canonical in ("dopri5", "dopri853"):
        from janus_tpu.solve.dopri import TABLEAUS, solve_erk
        return solve_erk(TABLEAUS[canonical], f, t0, tf, y0, args, options,
                         t_eval, events=events, step_args=step_args,
                         quad=quad, dense=dense)
    if canonical in ("radau", "radaup"):
        stages = {"radau5": 3, "radau9": 5, "radau13": 7}.get(method)
        if stages is not None:
            options = options.replace(min_stages=stages, max_stages=stages)
        if method == "radaup" and options.min_stages == options.max_stages:
            # variable order by default: stages 1..7
            options = options.replace(min_stages=1, max_stages=7)
        if options.min_stages != options.max_stages:
            if options.pallas_lu:
                raise ValueError("Options(pallas_lu=True) runs with a fixed "
                                 "stage count (e.g. method='radau9'); the "
                                 "variable-order ladder has no kernel path")
            if step_args is not None:
                raise ValueError("step_args= needs a fixed-stage radau "
                                 "(e.g. method='radau5'); the variable-"
                                 "order ladder re-attempts steps across "
                                 "orders with no slab-row contract")
            from janus_tpu.solve.radaup import solve_radau_vo
            return solve_radau_vo(f, t0, tf, y0, args, options, t_eval,
                                  jac=jac, mass=mass, events=events,
                                  tangents=tangents,
                                  args_tangents=args_tangents, quad=quad,
                                  dense=dense)
        from janus_tpu.solve.radau import solve_radau
        return solve_radau(f, t0, tf, y0, args, options, t_eval,
                           jac=jac, mass=mass, events=events,
                           tangents=tangents, args_tangents=args_tangents,
                           quad=quad, dense=dense, step_args=step_args)
    if canonical == "bdf":
        from janus_tpu.solve.ndf import solve_bdf
        # variable-order 1-5 with the NDF kappas (as scipy's BDF)
        return solve_bdf(f, t0, tf, y0, args, options, t_eval,
                         jac=jac, events=events, mass=mass,
                         tangents=tangents, args_tangents=args_tangents,
                         quad=quad, dense=dense,
                         ndf=(method != "bdf_classic"))
    if canonical == "bdf2":
        from janus_tpu.solve.bdf import solve_bdf2
        return solve_bdf2(f, t0, tf, y0, args, options, t_eval, jac=jac)
    if canonical == "seulex":
        from janus_tpu.solve.seulex import solve_seulex
        return solve_seulex(f, t0, tf, y0, args, options, t_eval,
                            jac=jac, mass=mass, events=events,
                            tangents=tangents, args_tangents=args_tangents,
                            quad=quad, dense=dense, step_args=step_args)
    if canonical == "rodas":
        from janus_tpu.solve.rodas import solve_rodas
        return solve_rodas(f, t0, tf, y0, args, options, t_eval,
                           jac=jac, mass=mass, events=events,
                           tangents=tangents, args_tangents=args_tangents,
                           quad=quad, dense=dense, step_args=step_args)
    if canonical == "grk4t":
        from janus_tpu.solve.rosenbrock import solve_ros4
        return solve_ros4(f, t0, tf, y0, args, options, t_eval, jac=jac)
    raise AssertionError("unreachable")


def radau_adjoint(*a, **kw):
    """Reverse-differentiable adaptive Radau final state (continuous
    adjoint); see janus_tpu.solve.adjoint.radau_adjoint."""
    from janus_tpu.solve.adjoint import radau_adjoint as _impl
    return _impl(*a, **kw)


def radau_hvp(*a, **kw):
    """Hessian-vector products through the adaptive Radau solve
    (forward-over-adjoint); see janus_tpu.solve.hvp.radau_hvp."""
    from janus_tpu.solve.hvp import radau_hvp as _impl
    return _impl(*a, **kw)


def rodas_adjoint(*a, **kw):
    """Reverse-differentiable adaptive RODAS4 final state (discrete
    adjoint — the exact transpose of the frozen-mesh step map); see
    janus_tpu.solve.adjoint_rodas.rodas_adjoint."""
    from janus_tpu.solve.adjoint_rodas import rodas_adjoint as _impl
    return _impl(*a, **kw)


def seulex_adjoint(*a, **kw):
    """Reverse-differentiable adaptive SEULEX final state (discrete
    adjoint — vjp of the frozen-mesh extrapolation-ladder replay); see
    janus_tpu.solve.adjoint_seulex.seulex_adjoint."""
    from janus_tpu.solve.adjoint_seulex import seulex_adjoint as _impl
    return _impl(*a, **kw)


def dopri_adjoint(*a, **kw):
    """Reverse-differentiable adaptive Dormand-Prince final state (discrete
    adjoint — exact vjp of the frozen-mesh explicit stage cascade; the
    neural-ODE training path); see
    janus_tpu.solve.adjoint_dopri.dopri_adjoint."""
    from janus_tpu.solve.adjoint_dopri import dopri_adjoint as _impl
    return _impl(*a, **kw)


def ndf_adjoint(*a, **kw):
    """Reverse-differentiable adaptive NDF/BDF (orders 1-5) final state
    (discrete adjoint — difference-array cotangents over the recorded
    mesh, implicit-function corrector transposes); see
    janus_tpu.solve.adjoint_ndf.ndf_adjoint."""
    from janus_tpu.solve.adjoint_ndf import ndf_adjoint as _impl
    return _impl(*a, **kw)


def solve_adjoint(f: Callable, tspan, y0, method: str = "radau",
                  args: Any = None, options: Optional[Options] = None,
                  t_eval=None, **kw):
    """Reverse-differentiable batched solve — the ``solve_ivp`` counterpart
    for training/optimization loops. Returns y(T) [M, D] (or ys [M, T, D]
    with ``t_eval=``); ``jax.grad`` of any function of the result flows
    through the family's adjoint w.r.t. y0, args leaves, t0, tf, and the
    sample times.

    method: 'radau' (continuous adjoint: also takes events=, cost=, n_alg=,
    checkpoints=, mass=, jac= — see radau_adjoint), 'radaup' (the same
    continuous adjoint over the variable-order forward ladder: per-lane
    order adaptivity in the recorded mesh, top-order backward collocation;
    LU stage solver only), 'rodas' / 'seulex' / 'bdf' (discrete adjoints;
    mass=, jac=), 'dopri5' / 'dopri853' (discrete adjoint on the explicit
    family). 'rodas', 'bdf', and the dopri methods also take terminal
    events= — they return (y*, t*), both reverse-differentiable (the
    neural-ODE-with-stopping-condition training path), and events COMPOSE
    with t_eval on every family like radau (zero-length post-trigger
    segments; NaN samples strictly past t*). EVERY discrete adjoint
    ('rodas', 'seulex', 'bdf', and the dopri methods) also takes cost=
    (integral Lagrange objectives: q̄ pulled through each recorded step's
    replayed GL-3 quadrature increment on the family's own rebuilt
    interpolant — the reverse twin of the CVODES forward quadrature
    sensitivities). The stiff discrete adjoints ('rodas'/'seulex'/'bdf')
    also take n_alg= (trailing algebraic variables of a semi-explicit
    index-1 DAE): t0/tf cotangents then use the constrained velocity
    instead of M⁻¹f, so DAE lanes get boundary-time gradients too.
    Aliases follow solve_ivp's table.
    Unsupported methods raise — forward-mode (tangents=/jet) covers the
    rest; reference: the upstream framework has forward duals only.
    """
    method = _ALIASES.get(method, method)
    if method == "radau":
        return radau_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, **kw)
    if method == "radaup":
        # variable order by default, like solve_ivp: the forward solve is
        # the per-lane order ladder; the backward sweep integrates the
        # linear adjoint ODE at the ladder's top order on the recorded mesh
        opts = options if options is not None else Options()
        if opts.min_stages == opts.max_stages:
            opts = opts.replace(min_stages=1, max_stages=7)
        return radau_adjoint(f, tspan, y0, args=args, options=opts,
                             t_eval=t_eval, **kw)
    if method == "rodas":
        return rodas_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, **kw)
    if method == "seulex":
        return seulex_adjoint(f, tspan, y0, args=args, options=options,
                              t_eval=t_eval, **kw)
    if method == "bdf":
        return ndf_adjoint(f, tspan, y0, args=args, options=options,
                           t_eval=t_eval, **kw)
    if method in ("dopri5", "dopri853"):
        return dopri_adjoint(f, tspan, y0, args=args, options=options,
                             t_eval=t_eval, method=method, **kw)
    raise ValueError(
        f"solve_adjoint: no reverse mode for method {method!r}; available: "
        "radau/radaup (continuous), rodas/seulex/bdf (discrete), "
        "dopri5/dopri853 (discrete). Forward sensitivities cover every "
        "method (solve_ivp(tangents=) / jet.dual_solve_ivp)")


__all__ = [
    "solve_ivp", "Solution", "Options", "FEATURES", "radau_adjoint",
    "radau_hvp", "rodas_adjoint", "seulex_adjoint", "dopri_adjoint",
    "ndf_adjoint", "solve_adjoint",
    "RUNNING", "SUCCESS", "MAX_STEPS", "STEP_UNDERFLOW", "NEWTON_STALL",
    "EVENT_TERMINATED", "PARAMS_EXHAUSTED",
]
