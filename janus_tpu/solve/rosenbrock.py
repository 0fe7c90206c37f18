"""Batched adaptive Kaps–Rentrop ROS4 (4th order Rosenbrock, embedded 3rd).

The reference carries ROS4 in three flavors (src/python/stepper_ross.py NR
port, examples rosenbrock_torch_gmres.py ROS4+GMRES, src/fortran/radau.f which
actually contains Hairer's RODAS). Rosenbrock methods are linearly implicit:
no Newton loop — one Jacobian + one LU per step, four triangular solves.
Coefficients are the published Kaps–Rentrop set (Press et al., NR §16.6;
Hairer-Wanner GRK4T family).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok
from janus_tpu.solve import common as cm
from janus_tpu.solve.options import Options
from janus_tpu.solve.radau import default_jacobian

# Kaps–Rentrop GRK4T coefficients (published; Hairer-Wanner IV.7 / NR).
# Validated symbolically at build time: R(z) matches e^z through z⁴ and the
# embedded error estimator is O(z⁴) (see tests/test_stiff_methods.py).
GAM = 0.231
A21 = 2.0
A31, A32 = 4.52470820736, 4.16352878860
C21 = -5.07167533877
C31, C32 = 6.02015272865, 0.159750684673
C41, C42, C43 = -1.856343618677, -8.50538085819, -2.08407513602
B1, B2, B3, B4 = 3.95750374663, 4.62489238836, 0.617477263873, 1.282612945268
E1, E2, E3, E4 = -2.30215540292, -3.07363448539, 0.873280801802, 1.282612945268
C1X, C2X, C3X, C4X = GAM, -0.0396296677520, 0.550778939579, -0.0553509845700
A2X, A3X = 0.462, 0.880208333333


@struct.dataclass
class _RosState:
    t: jnp.ndarray
    y: jnp.ndarray
    h: jnp.ndarray
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any


def solve_ros4(f: Callable, t0, tf, y0, args=None,
               options: Optional[Options] = None, t_eval=None,
               jac: Optional[Callable] = None) -> cm.Solution:
    opts = options if options is not None else Options()
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    jac_fn = jac if jac is not None else default_jacobian(f)

    f0 = f(t0, y0, args)
    if opts.h0 == 0.0:
        h = cm.initial_step(f, t0, y0, f0, tf, 4, opts.rtol, opts.atol,
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
                              "nreject"))
    stats["nfev"] = stats["nfev"] + 2
    already_done = t0 == tf
    state = _RosState(
        t=t0, y=y0, h=h, active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys,
    )
    eps = jnp.finfo(dtype).eps

    def dfdt(t, y):
        _, ft = jax.jvp(lambda tt: f(tt, y, args), (t,), (jnp.ones_like(t),))
        return ft

    def cond(st):
        return jnp.any(st.active)

    def body(st):
        remaining = tf - st.t
        last = jnp.abs(st.h) >= jnp.abs(remaining)
        h = jnp.where(last, remaining, st.h)
        h = jnp.where(h == 0.0, eps, h)
        hcol = h[:, None]

        jmat = jac_fn(st.t, st.y, args)
        amat = (1.0 / (GAM * h))[:, None, None] * jnp.eye(dim, dtype=dtype) \
            - jmat
        lu, piv = lu_factor(amat, pivot=opts.pivoting)
        ok = lu_ok(lu)

        fy = f(st.t, st.y, args)
        ft = dfdt(st.t, st.y)

        g1 = lu_solve(lu, piv, fy + hcol * C1X * ft)
        f2 = f(st.t + A2X * h, st.y + A21 * g1, args)
        g2 = lu_solve(lu, piv, f2 + hcol * C2X * ft + (C21 / hcol) * g1)
        f3 = f(st.t + A3X * h, st.y + A31 * g1 + A32 * g2, args)
        g3 = lu_solve(lu, piv,
                      f3 + hcol * C3X * ft + (C31 * g1 + C32 * g2) / hcol)
        g4 = lu_solve(lu, piv,
                      f3 + hcol * C4X * ft
                      + (C41 * g1 + C42 * g2 + C43 * g3) / hcol)
        y_new = st.y + B1 * g1 + B2 * g2 + B3 * g3 + B4 * g4
        err = E1 * g1 + E2 * g2 + E3 * g3 + E4 * g4

        enorm = cm.error_norm(err, st.y, y_new, opts.rtol, opts.atol)
        enorm = jnp.where(jnp.isfinite(enorm) & ok, enorm, 1e10)
        enorm = jnp.maximum(enorm, 1e-16)
        accept = st.active & (enorm <= 1.0)

        factor = opts.safety * enorm ** -0.25
        fac = jnp.clip(factor, opts.min_factor, opts.max_factor)
        fac = jnp.where(accept, fac, jnp.clip(factor, opts.min_factor, 0.9))

        out_ys = st.out_ys
        if use_dense:
            # cubic Hermite on (y, f(y)) – (y_new, f(y_new))
            fn = f(st.t + h, y_new, args)

            def interp(theta):
                th = theta[..., None]
                h00 = (1 + 2 * th) * (1 - th) ** 2
                h10 = th * (1 - th) ** 2
                h01 = th * th * (3 - 2 * th)
                h11 = th * th * (th - 1)
                return (h00 * st.y[:, None] + h10 * hcol[:, None] * fy[:, None]
                        + h01 * y_new[:, None]
                        + h11 * hcol[:, None] * fn[:, None])
            out_ys = cm.collect_dense(out_ys, t_eval, st.t, h, accept, interp)

        t_new = st.t + h
        done = accept & last

        stats = dict(st.stats)
        stats["nfev"] = stats["nfev"] + st.active * 3 \
            + (accept * (1 if use_dense else 0))
        stats["njev"] = stats["njev"] + st.active
        stats["nlu"] = stats["nlu"] + st.active
        stats["nsteps"] = stats["nsteps"] + st.active
        stats["naccept"] = stats["naccept"] + accept
        stats["nreject"] = stats["nreject"] + (st.active & ~accept)

        h_next_abs = jnp.minimum(jnp.abs(h) * fac, opts.max_step)
        h_next = jnp.where(st.active, h_next_abs * jnp.sign(h), st.h)
        exceeded = st.active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test (an absolute floor rejects
        # legitimate tiny f32 steps; cf. solve/radau.py)
        underflow = st.active & (0.1 * h_next_abs <= eps * jnp.abs(t_new)) \
            & ~done

        status = st.status
        status = jnp.where(done, cm.SUCCESS, status).astype(jnp.int8)
        status = jnp.where(exceeded, cm.MAX_STEPS, status).astype(jnp.int8)
        status = jnp.where(underflow, cm.STEP_UNDERFLOW, status).astype(jnp.int8)
        active = st.active & ~done & ~exceeded & ~underflow

        return _RosState(
            t=jnp.where(accept, t_new, st.t),
            y=jnp.where(accept[:, None], y_new, st.y),
            h=h_next, active=active, status=status, stats=stats,
            out_ys=out_ys)

    final = jax.lax.while_loop(cond, body, state)
    return cm.Solution(
        t=final.t, y=final.y, status=final.status, stats=final.stats,
        ts=t_eval if use_dense else None,
        ys=final.out_ys if use_dense else None,
    )
