"""Batched adaptive BDF2 — A-stable two-step method behind the lockstep driver.

Re-designs the reference's BDF-2 kernel (src/python/odesolvers/bdf2_step.py:11-59
γ=2/(3h) with the CommonIntegrator Newton; examples bdf2.py/bdf_torch.py) as a
variable-step, per-trajectory-adaptive batched method:

- variable-step BDF2: α(r)·y₊ − ψ(r; yₙ, yₙ₋₁) = h·f(t₊, y₊), r = hₙ/hₙ₋₁;
- simplified Newton with the (α/h·I − J) LU reused across iterations;
- LTE estimate from third divided differences of the history (startup step is
  BDF1 with an h²y″ estimate), smoothed by the stage LU for stiff robustness;
- startup/controller/masking identical in structure to solve/radau.py.
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

NEWTON_MAXITER = 6


@struct.dataclass
class _BdfState:
    t: jnp.ndarray
    y: jnp.ndarray
    f0: jnp.ndarray
    h: jnp.ndarray
    # history for the 2-step formula and the error estimate
    t1: jnp.ndarray           # t_{n-1}
    y1: jnp.ndarray
    t2: jnp.ndarray           # t_{n-2}
    y2: jnp.ndarray
    nhist: jnp.ndarray        # [M] 0/1/2 back points available
    jac: jnp.ndarray
    lu: jnp.ndarray
    piv: jnp.ndarray
    alpha_fact: jnp.ndarray   # [M] α/h the factors were built with (0 = none)
    current_jac: jnp.ndarray
    need_jac: jnp.ndarray
    rejected: jnp.ndarray
    nsing: jnp.ndarray
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any


def solve_bdf2(f: Callable, t0, tf, y0, args=None,
               options: Optional[Options] = None, t_eval=None,
               jac: Optional[Callable] = None) -> cm.Solution:
    opts = options if options is not None else Options()
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype
    jac_fn = jac if jac is not None else default_jacobian(f)
    newton_tol = (opts.newton_tol if opts.newton_tol > 0
                  else cm.derived_newton_tol(dtype, opts.rtol))

    f0 = f(t0, y0, args)
    if opts.h0 == 0.0:
        h = cm.initial_step(f, t0, y0, f0, tf, 2, opts.rtol, opts.atol,
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
    already_done = t0 == tf
    state = _BdfState(
        t=t0, y=y0, f0=f0, h=h,
        t1=t0, y1=y0, t2=t0, y2=y0,
        nhist=jnp.zeros((m,), jnp.int32),
        jac=jnp.zeros((m, dim, dim), dtype),
        lu=jnp.zeros((m, dim, dim), dtype),
        piv=jnp.zeros((m, dim), jnp.int32),
        alpha_fact=jnp.zeros((m,), dtype),
        current_jac=jnp.zeros((m,), bool),
        need_jac=jnp.ones((m,), bool),
        rejected=jnp.zeros((m,), bool),
        nsing=jnp.zeros((m,), jnp.int32),
        active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys,
    )
    eps = jnp.finfo(dtype).eps

    def cond(st):
        return jnp.any(st.active)

    def body(st):
        remaining = tf - st.t
        last = jnp.abs(st.h) >= jnp.abs(remaining)
        h = jnp.where(last, remaining, st.h)
        h = jnp.where(h == 0.0, eps, h)

        startup = st.nhist == 0                      # BDF1 first step
        hprev = jnp.where(startup, h, st.t - st.t1)
        hprev = jnp.where(hprev == 0.0, h, hprev)
        r = h / hprev
        alpha = jnp.where(startup, 1.0, (1.0 + 2.0 * r) / (1.0 + r))
        psi = jnp.where(startup[:, None], st.y,
                        (1.0 + r)[:, None] * st.y
                        - (r * r / (1.0 + r))[:, None] * st.y1)

        # Jacobian refresh (gated)
        needj = st.need_jac & st.active

        def do_jac(_):
            jn = jac_fn(st.t, st.y, args)
            return jnp.where(needj[:, None, None], jn, st.jac)

        jmat = jax.lax.cond(jnp.any(needj), do_jac, lambda _: st.jac, None)
        current_jac = st.current_jac | needj

        # Factorization of (α/h I − J) (gated)
        a_over_h = alpha / h
        needf = st.active & (needj | (a_over_h != st.alpha_fact))

        def do_fact(_):
            amat = a_over_h[:, None, None] * jnp.eye(dim, dtype=dtype) - jmat
            lu_n, piv_n = lu_factor(amat, pivot=opts.pivoting)
            ok = lu_ok(lu_n)
            return (jnp.where(needf[:, None, None], lu_n, st.lu),
                    jnp.where(needf[:, None], piv_n, st.piv),
                    jnp.where(needf, ok, jnp.ones((m,), bool)),
                    jnp.where(needf, a_over_h, st.alpha_fact))

        lu_m, piv_m, fact_ok, alpha_fact = jax.lax.cond(
            jnp.any(needf), do_fact,
            lambda _: (st.lu, st.piv, jnp.ones((m,), bool), st.alpha_fact),
            None)
        singular = st.active & ~fact_ok

        # Newton on F(y) = α·y − ψ − h·f(t₊, y) = 0
        t_new = st.t + h
        scale_n = opts.atol + opts.rtol * jnp.abs(st.y)
        ypred = jnp.where(startup[:, None], st.y,
                          st.y + (r[:, None] * (st.y - st.y1)))
        run_newton = st.active & fact_ok

        def nbody(carry):
            yk, dn_old, rate, k, running, convd, niter, nfev = carry
            fk = f(t_new, yk, args)
            res = fk + (psi - alpha[:, None] * yk) / h[:, None]
            dy = lu_solve(lu_m, piv_m, res)
            finite = jnp.all(jnp.isfinite(dy), axis=-1)
            dn = cm.safe_sqrt(jnp.mean(jnp.square(dy / scale_n), axis=-1))
            have = k > 0
            rt = jnp.where(have & (dn_old > 0),
                           dn / jnp.where(dn_old == 0, 1.0, dn_old), 0.0)
            srt = jnp.clip(rt, 1e-16, 1.0 - 1e-16)
            left = (NEWTON_MAXITER - k).astype(dtype)
            div = have & ((rt >= 1.0) | (srt ** left / (1 - srt) * dn
                                         > newton_tol))
            failn = running & (~finite | div)
            app = running & ~failn
            yk2 = jnp.where(app[:, None], yk + dy, yk)
            cnow = app & ((dn == 0.0)
                          | (have & (rt < 1.0)
                             & (srt / (1 - srt) * dn < newton_tol)))
            k1 = k + 1
            niter2 = jnp.where(running, k1, niter)
            running2 = running & ~failn & ~cnow & (k1 < NEWTON_MAXITER)
            return (yk2, jnp.where(app, dn, dn_old),
                    jnp.where(running, rt, rate), k1, running2,
                    convd | cnow, niter2, nfev + running)

        def ncond(carry):
            return jnp.any(carry[4])

        init = (ypred, jnp.zeros((m,), dtype), jnp.zeros((m,), dtype),
                jnp.zeros((), jnp.int32), run_newton,
                jnp.zeros((m,), bool), jnp.zeros((m,), jnp.int32),
                jnp.zeros((m,), jnp.int32))
        (y_new, _, nrate, _, _, convd, niter, nfev_n) = jax.lax.while_loop(
            ncond, nbody, init)

        conv = run_newton & convd
        newton_fail = run_newton & ~convd
        nf_stale = newton_fail & ~current_jac
        nf_fresh = (newton_fail & current_jac) | singular

        # ---- error estimate ------------------------------------------------
        f_new = f(t_new, y_new, args)
        dt1 = t_new - st.t
        dt2 = t_new - st.t1
        dt3 = t_new - st.t2
        dd1a = (y_new - st.y) / dt1[:, None]
        dd1b = (st.y - st.y1) / jnp.where((st.t - st.t1) == 0, 1.0,
                                          st.t - st.t1)[:, None]
        dd1c = (st.y1 - st.y2) / jnp.where((st.t1 - st.t2) == 0, 1.0,
                                           st.t1 - st.t2)[:, None]
        dd2a = (dd1a - dd1b) / jnp.where(dt2 == 0, 1.0, dt2)[:, None]
        dd2b = (dd1b - dd1c) / jnp.where((st.t - st.t2) == 0, 1.0,
                                         st.t - st.t2)[:, None]
        dd3 = (dd2a - dd2b) / jnp.where(dt3 == 0, 1.0, dt3)[:, None]
        # LTE(y=τ³) = −h³(1+r)/r ⇒ err ≈ (1+r)/r · h³ · dd3 / α
        full_hist = st.nhist >= 2
        err_bdf2 = ((1.0 + r) / r * h ** 3 / alpha)[:, None] * dd3
        err_bdf1 = 0.5 * h[:, None] * (f_new - st.f0)
        err_raw = jnp.where(full_hist[:, None], err_bdf2, err_bdf1)
        # stiff smoothing with the existing LU: e = (α/h)(α/h·I − J)⁻¹ err
        err_s = lu_solve(lu_m, piv_m, err_raw) * a_over_h[:, None]
        scale_e = opts.atol + opts.rtol * jnp.maximum(jnp.abs(st.y),
                                                      jnp.abs(y_new))
        enorm = cm.safe_sqrt(jnp.mean(jnp.square(err_s / scale_e), axis=-1))
        enorm = jnp.where(jnp.isfinite(enorm), enorm, 1e10)
        enorm = jnp.maximum(enorm, 1e-16)

        accept = conv & (enorm <= 1.0)
        reject_err = conv & (enorm > 1.0)

        # ---- controller (order 2 ⇒ exponent 1/3) --------------------------
        niter_f = jnp.maximum(niter, 1).astype(dtype)
        safety = opts.safety * (2 * NEWTON_MAXITER + 1) / (2 * NEWTON_MAXITER
                                                           + niter_f)
        factor = safety * enorm ** (-1.0 / 3.0)
        fac_acc = jnp.clip(factor, opts.min_factor, opts.max_factor)
        recompute_jac = accept & (niter > 2) & (nrate > opts.jac_recompute)
        deadzone = accept & ~recompute_jac & (fac_acc >= opts.quot1) & \
            (fac_acc < opts.quot2)
        fac_acc = jnp.where(deadzone, 1.0, fac_acc)
        fac_rej = jnp.clip(factor, opts.min_factor, 0.9)

        out_ys = st.out_ys
        if use_dense:
            # quadratic through (t_{n-1}, t_n, t_{n+1}) on accepted steps
            def interp(theta):
                tq = st.t[:, None] + theta * h[:, None]
                l0 = ((tq - st.t[:, None]) * (tq - st.t1[:, None])
                      / ((t_new - st.t) * (t_new - st.t1))[:, None])
                l1 = ((tq - t_new[:, None]) * (tq - st.t1[:, None])
                      / ((st.t - t_new) * (st.t - st.t1))[:, None])
                l2 = ((tq - t_new[:, None]) * (tq - st.t[:, None])
                      / ((st.t1 - t_new) * (st.t1 - st.t))[:, None])
                lin0 = (tq - st.t[:, None]) / (t_new - st.t)[:, None]
                quad = (l0[..., None] * y_new[:, None]
                        + l1[..., None] * st.y[:, None]
                        + l2[..., None] * st.y1[:, None])
                lin = (lin0[..., None] * y_new[:, None]
                       + (1 - lin0)[..., None] * st.y[:, None])
                return jnp.where((st.nhist >= 1)[:, None, None], quad, lin)
            out_ys = cm.collect_dense(out_ys, t_eval, st.t, h, accept, interp)

        done = accept & last

        stats = dict(st.stats)
        stats["nfev"] = stats["nfev"] + nfev_n + conv
        stats["njev"] = stats["njev"] + needj
        stats["nlu"] = stats["nlu"] + needf
        stats["nsteps"] = stats["nsteps"] + (run_newton | singular)
        stats["naccept"] = stats["naccept"] + accept
        stats["nreject"] = stats["nreject"] + (reject_err | newton_fail
                                               | singular)
        stats["nnewton"] = stats["nnewton"] + niter

        nsing = jnp.where(singular | newton_fail, st.nsing + 1,
                          jnp.where(accept, 0, st.nsing))
        stall = st.active & (nsing >= 7)
        exceeded = st.active & (stats["nsteps"] >= opts.max_steps) & ~done
        h_next_abs = jnp.where(accept, jnp.abs(h) * fac_acc,
                               jnp.where(reject_err, jnp.abs(h) * fac_rej,
                                         jnp.where(nf_fresh, jnp.abs(h) * 0.5,
                                                   jnp.abs(h))))
        h_next_abs = jnp.minimum(h_next_abs, opts.max_step)
        h_next = jnp.where(st.active, h_next_abs * jnp.sign(h), st.h)
        # Hairer's t-relative underflow test (an absolute floor rejects
        # legitimate tiny f32 steps; cf. solve/radau.py)
        underflow = st.active & (0.1 * h_next_abs <= eps * jnp.abs(t_new)) \
            & ~done

        status = st.status
        status = jnp.where(done, cm.SUCCESS, status).astype(jnp.int8)
        status = jnp.where(exceeded, cm.MAX_STEPS, status).astype(jnp.int8)
        status = jnp.where(underflow, cm.STEP_UNDERFLOW, status).astype(jnp.int8)
        status = jnp.where(stall, cm.NEWTON_STALL, status).astype(jnp.int8)
        active = st.active & ~done & ~exceeded & ~underflow & ~stall

        return _BdfState(
            t=jnp.where(accept, t_new, st.t),
            y=jnp.where(accept[:, None], y_new, st.y),
            f0=jnp.where(accept[:, None], f_new, st.f0),
            h=h_next,
            t1=jnp.where(accept, st.t, st.t1),
            y1=jnp.where(accept[:, None], st.y, st.y1),
            t2=jnp.where(accept, st.t1, st.t2),
            y2=jnp.where(accept[:, None], st.y1, st.y2),
            nhist=jnp.where(accept, jnp.minimum(st.nhist + 1, 2), st.nhist),
            jac=jmat, lu=lu_m, piv=piv_m,
            alpha_fact=jnp.where(accept & ~deadzone, 0.0,
                                 jnp.where(reject_err | nf_fresh, 0.0,
                                           alpha_fact)),
            current_jac=jnp.where(accept, False, current_jac),
            need_jac=jnp.where(accept, recompute_jac,
                               jnp.where(nf_stale, True,
                                         jnp.where(needj, False,
                                                   st.need_jac))),
            rejected=jnp.where(accept, False,
                               st.rejected | reject_err | newton_fail),
            nsing=nsing,
            active=active, status=status, stats=stats, out_ys=out_ys,
        )

    final = jax.lax.while_loop(cond, body, state)
    return cm.Solution(
        t=final.t, y=final.y, status=final.status, stats=final.stats,
        ts=t_eval if use_dense else None,
        ys=final.out_ys if use_dense else None,
    )
