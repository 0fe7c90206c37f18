"""Dual-number solves: the RadauTeD / SeulexTed capability as a transform.

The reference threads TensorDual through every line of the integrator
(src/cpp/radauted_impl.hpp — 2929 lines). Here the SAME capability is one
wrapper: seed N tangent directions, push each through the (jvp-differentiable)
adaptive solve with ``vmap(jvp)``, return a Jet solution. Sensitivities flow
through step-size selection, Newton, accept/reject — exactly as the
reference's duals do — including the final-time column (the extra dual column
of reference tests/cpp/ode_solver_test.cpp:647: pass a Jet tf).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from janus_tpu.jet.core import Jet, const, seed_identity
from janus_tpu.solve import solve_ivp


def dual_solve_ivp(f: Callable, tspan, y0, method: str = "radau",
                   args: Any = None, options=None, **kw):
    """solve_ivp with Jet-valued y0 / tf / args leaves.

    Any of y0, tspan[1], or args leaves may be Jets (sharing one sensitivity
    width N). Returns (y_final as Jet [M,D], t_final as Jet [M], Solution of
    the primal solve for stats/status).
    """
    t0, tf = tspan

    jets = []

    def split(x):
        if isinstance(x, Jet):
            jets.append(x)
            return x.r
        return x

    y0_r = split(y0)
    tf_r = split(tf)
    args_r = jax.tree_util.tree_map(split, args,
                                    is_leaf=lambda a: isinstance(a, Jet))
    if not jets:
        raise ValueError("dual_solve_ivp: no Jet inputs; use solve_ivp")
    n = jets[0].nsens

    def tangent_of(x, xr):
        if isinstance(x, Jet):
            return x.d
        z = jnp.asarray(xr)
        return jnp.zeros((n,) + z.shape, z.dtype)

    y0_d = tangent_of(y0, y0_r)
    tf_d = tangent_of(tf, tf_r)
    args_d = jax.tree_util.tree_map(tangent_of, args, args_r,
                                    is_leaf=lambda a: isinstance(a, Jet))

    # fast path: the internal-differentiation sweep (tangents=/
    # args_tangents=) computes the same sensitivities in ONE primal solve,
    # reusing each step's LU factors. Radau — fixed-stage AND the
    # variable-order ladder — takes t_eval AND events (event-time tangents
    # come back via Solution.sens_t); seulex/rodas/bdf are terminal-mode;
    # a Jet tf costs one extra rhs call (dy/dT = f(T, y(T))) unless
    # combined with mass/events.
    # Everything else falls back to the transform with a warning.
    tf_is_jet = isinstance(tf, Jet)
    from janus_tpu.solve import Options as _Options
    _opt_fields = set(_Options.__dataclass_fields__)
    if method in ("radau", "radau5", "radau9", "radau13", "radaup",
                  "seulex", "rodas", "bdf", "ndf", "bdf_classic"):
        terminal_only = method in ("seulex", "rodas", "bdf",
                                   "ndf", "bdf_classic")
        pass_kw = {"jac", "mass"} | (set() if terminal_only
                                     else {"t_eval", "events"})
        blockers = []
        if tf_is_jet and ("mass" in kw or "events" in kw):
            # dy/dtf = M⁻¹f needs a mass solve; an event lane's terminal
            # time is t*, not tf — both stay on the transform path
            blockers.append("tf tangents with mass/events")
        extra_kw = set(kw) - pass_kw - _opt_fields
        if extra_kw:
            blockers.append(f"kwargs {sorted(extra_kw)}"
                            + (f" ({method} IND is terminal-mode only)"
                               if terminal_only else ""))
        if not blockers:
            o = options if options is not None else _Options()
            o = o.replace(**{k: v for k, v in kw.items() if k in _opt_fields})
            kw = {k: v for k, v in kw.items() if k in pass_kw}
            options = o
            if method in ("radau", "radau5", "radau9", "radau13") \
                    and o.min_stages != o.max_stages:
                blockers.append("variable stage count "
                                "(min_stages != max_stages)")
            if o.stage_solver != "lu" and method not in (
                    "radau", "radau5", "radau9", "radau13", "bdf", "ndf",
                    "bdf_classic"):
                blockers.append("stage_solver='gmres' (IND rides the "
                                "matrix-free stage solvers in radau and "
                                "bdf only)")
        if not blockers:
            args_has_d = any(isinstance(a, Jet)
                             for a in jax.tree_util.tree_leaves(
                                 args, is_leaf=lambda x: isinstance(x, Jet)))
            sol = solve_ivp(f, (t0, tf_r), y0_r, method=method, args=args_r,
                            options=options,
                            tangents=y0_d,
                            args_tangents=args_d if args_has_d else None,
                            **kw)
            sens = sol.sens
            dtz = jnp.zeros((n,) + sol.t.shape, sol.t.dtype)
            if tf_is_jet:
                # terminal-time column: dy(T)/dT = f(T, y(T)) — one rhs
                # call corrects the IND result (reference ode_solver_test
                # :647's extra dual column on tf)
                f_term = f(sol.t, sol.y, args_r)
                tfd = tf_d if tf_d.ndim == 2 else tf_d[:, None]
                tfd = jnp.broadcast_to(tfd, (n,) + sol.t.shape).astype(
                    sol.t.dtype)
                sens = sens + tfd[:, :, None] * f_term[None]
                dtz = tfd
            if sol.sens_t is not None:
                # event-terminated lanes: t* moves with the seeds
                # (implicit-function dt*; zero on lanes that ran to tf)
                dtz = sol.sens_t
            return Jet(sol.y, sens), Jet(sol.t, dtz), sol
        import warnings
        warnings.warn(
            "dual_solve_ivp: falling back to the vmapped-jvp transform "
            f"(slower than internal differentiation) because: "
            f"{'; '.join(blockers)}", stacklevel=2)

    def primal(y0p, tfp, argsp):
        sol = solve_ivp(f, (t0, tfp), y0p, method=method, args=argsp,
                        options=options, **kw)
        return sol.y, sol.t

    sol_full = solve_ivp(f, (t0, tf_r), y0_r, method=method, args=args_r,
                         options=options, **kw)

    def one(dy0, dtf, dargs):
        _, tans = jax.jvp(primal, (y0_r, tf_r, args_r), (dy0, dtf, dargs))
        return tans

    dy, dt = jax.vmap(one)(y0_d, tf_d, args_d)
    return Jet(sol_full.y, dy), Jet(sol_full.t, dt), sol_full


def solve_with_sensitivities(f: Callable, tspan, y0, method: str = "radau",
                             args: Any = None, options=None,
                             wrt_tf: bool = False, **kw):
    """Convenience: identity-seed ∂y(T)/∂y0 (+ optional final-time column).

    Returns (Jet y_final with N = D (+1) sensitivities, Solution).
    d[j] for j < D is ∂y(T)/∂y0_j; the last column (if wrt_tf) is
    ∂y(T)/∂T = f(T, y(T)).
    """
    y0 = jnp.atleast_2d(jnp.asarray(y0))
    extra = 1 if wrt_tf else 0
    y0j = seed_identity(y0, extra=extra)
    t0, tf = tspan
    if wrt_tf:
        m = y0.shape[0]
        tfr = jnp.broadcast_to(jnp.asarray(tf, y0.dtype), (m,))
        dtf = jnp.zeros((y0.shape[-1] + 1, m), y0.dtype)
        dtf = dtf.at[-1].set(1.0)
        tf_in = Jet(tfr, dtf)
    else:
        tf_in = tf
    yj, tjet, sol = dual_solve_ivp(f, (t0, tf_in), y0j, method=method,
                                   args=args, options=options, **kw)
    return yj, sol
