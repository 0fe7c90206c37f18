"""Discrete-adjoint reverse mode on the batched Dormand-Prince solvers.

``dopri_adjoint`` returns the final state of an adaptive ``solve_erk`` run
(dopri5 or dopri853) as a ``jax.custom_vjp`` whose backward pass is the
exact transpose of the solver's step map on the recorded accepted-step
mesh. One accepted explicit-RK step is a closed-form composition of stage
evaluations

    y_{n+1} = Φ(t_n, h_n, y_n, θ) = y_n + h_n Σ_j b_j k_j

so its vjp (``jax.vjp`` of a replay at the recorded (t_n, h_n)) is exact to
machine precision — this is reverse mode through the ADAPTIVE explicit
family, the neural-ODE training workhorse (torchdiffeq/diffrax's
"discretize-then-optimize" role), which previously only had forward-mode
(jvp/jet) here. The backward pass is a ``lax.scan`` over steps with
per-lane live masks and benign-value substitution on dead mesh slots (the
solve/adjoint_rodas.py mechanics; each backward step costs one ~s-stage
replay + its reverse sweep, about 3 forward steps of work).

Replay exactness needs NO forward-pass change: the FSAL derivative the
driver carries always equals a fresh ``f(t_n, y_n)`` (it was evaluated at
exactly that point when the previous step was accepted — solve/dopri.py
``f0_n``), so the replay's stage-0 evaluation reproduces the forward
stages bit-for-bit (asserted in tests/test_adjoint_dopri.py).

Frozen-mesh convention: (t_n, h_n) are data; against FD of the full solver
the gradients differ by the controller's O(local error) = O(rtol)
sensitivity — the rodas_adjoint/IND accuracy contract, including the
long-limit-cycle amplification caution (tighten rtol on oscillatory
horizons). Dead mesh slots replay the identity: the stage cascade is
masked to zero RHS for non-live lanes, because an explicit stage cascade
at a benign substitute point with stiff parameters can overflow to inf and
0-cotangent x inf = NaN pollutes per-lane arg-leaf gradients (lane-masked
cotangents do NOT protect leaf cotangents — the recorded rodas/seulex
dead-slot lesson).

Scope: terminal mode, ``t_eval=`` trajectory sampling (chained
warm-started adaptive segments, the radau/rodas/seulex adjoint
convention), terminal ``events=`` — ``(y*, t*)`` both
reverse-differentiable via the vjp of the triggering step's replayed
dense interpolant with a differentiable Newton re-polish of θ* (the
rodas_adjoint event mechanics; events COMPOSE with t_eval — the seg_ev
zero-length-segment convention, now shared by every discrete adjoint) —
and integral costs (``cost=``: q̄ pulled through each step's replayed
GL-3 increment on the rebuilt dense interpolant, bit-identical to the
forward ``quad=`` accumulation). The reference's explicit family has
forward duals only (src/cpp/dopri853ted.hpp — every state a TensorDual).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from janus_tpu.solve import common as cm
from janus_tpu.solve.adjoint import _split_diff
from janus_tpu.solve.dopri import (TABLEAUS, solve_erk, _dense_eval_rk45,
                                   _dense_eval_dop853, _dop853_fall)
from janus_tpu.solve.options import Options


def _one_step(tab, f, t, h, y, args, live=None, want_interp=False):
    """Replay ONE accepted explicit-RK step at frozen (t, h) — the
    differentiable step map Φ. Mirrors solve/dopri.py _stages exactly
    (stage 0 = fresh f(t, y) = the FSAL value, see module docstring); the
    trailing FSAL evaluation f(t+h, y1) does not feed y1 and is omitted
    unless ``want_interp`` asks for the step's dense interpolant (the
    event endpoint needs it — rk45's quartic uses f_new's row of P;
    dop853 rebuilds the 3 extra interpolation stages too).
    ``live`` masks the RHS to zero for lanes replaying a dead mesh slot, so
    their cascade is the identity (explicit stages can overflow at benign
    substitute points with stiff parameters)."""

    def feval(tt, yy):
        fv = f(tt, yy, args)
        return fv if live is None else jnp.where(live[:, None], fv, 0.0)

    ks = [feval(t, y)]
    for i in range(1, tab.n_stages):
        acc = ks[0] * tab.a[i, 0]
        for j in range(1, i):
            if tab.a[i, j] != 0.0:
                acc = acc + ks[j] * tab.a[i, j]
        ks.append(feval(t + tab.c[i] * h, y + h[:, None] * acc))
    acc = None
    for j in range(tab.n_stages):
        if tab.b[j] != 0.0:
            term = ks[j] * tab.b[j]
            acc = term if acc is None else acc + term
    y1 = y + h[:, None] * acc
    if not want_interp:
        return y1
    f_new = feval(t + h, y1)
    if tab.dense == "rk45P":
        interp = _dense_eval_rk45(tab, ks + [f_new], y, h)
    else:
        fall = _dop853_fall(tab, lambda tt, yy, aa: feval(tt, yy),
                            t, y, y1, f_new, h, ks + [f_new], args)
        interp = _dense_eval_dop853(fall, y)
    return y1, interp


def _gl3_inc(lq, t, h, interp, theta_q):
    """One step's running-cost increment: 3-point Gauss-Legendre on the
    replayed dense interpolant over [0, θ_q] — the SAME arithmetic as the
    forward ``cm.quad_gl3_step``, so the full-step increment (θ_q = 1)
    reproduces the forward accumulation bit-for-bit and its vjp is the
    exact discrete quadrature adjoint."""
    dtype = t.dtype
    s35 = 0.6 ** 0.5
    gl_xi = jnp.asarray([0.5 * (1 - s35), 0.5, 0.5 * (1 + s35)], dtype)
    gl_w = jnp.asarray([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0], dtype)
    nodes = theta_q[:, None] * gl_xi[None, :]              # [M, 3]
    yq = interp(nodes)                                     # [M, 3, D]
    tq = t[:, None] + nodes * h[:, None]
    lv = jnp.stack([lq(tq[:, i], yq[:, i]) for i in range(3)],
                   axis=1)                                 # [M, 3, Q]
    return (h * theta_q)[:, None] * jnp.sum(gl_w[None, :, None] * lv,
                                            axis=1)


def dopri_adjoint(f: Callable, tspan, y0, args=None,
                  options: Optional[Options] = None, t_eval=None,
                  method: str = "dopri5", events=None,
                  cost: Optional[Callable] = None):
    """Reverse-differentiable batched adaptive Dormand-Prince solve.

    Returns the final state y(T) [M, D], or — with ``t_eval`` — the sampled
    trajectory ys [M, T, D]. ``jax.grad``/``jax.vjp`` of any function of the
    result flows through the discrete adjoint w.r.t. y0, every inexact leaf
    of ``args``, t0, tf, and (in t_eval mode) the sample times. Memory: the
    reverse pass stores one (t, h, y)-slot per accepted step,
    ``options.adjoint_steps`` slots per lane PER SEGMENT (gradient poisoned
    with NaN on overflow).

    method: 'dopri5' (7 stages, order 5) or 'dopri853' (13 stages, order 8).

    t_eval: optional strictly monotonic 1-D grid inside (t0, tf], ordered in
    the integration direction. The solve is CHAINED over the segments
    t0 → t_eval[0] → … → t_eval[-1], each an adaptive solve warm-started
    with the previous segment's step proposal, so samples are exact solve
    endpoints (the radau_adjoint convention, solve/adjoint.py:100-110).
    Integration stops at t_eval[-1] — include tf to get the endpoint.

    events: optional TERMINAL event spec(s). Returns ``(y, t)``: the state
    and time each lane stopped at ((y*, t*) on triggered lanes), BOTH
    reverse-differentiable — the neural-ODE-with-stopping-condition
    training path. The triggering step's cotangents pull through the vjp
    of its replayed dense interpolant (the rk45 quartic / dop853 degree-7
    extension) with θ* re-polished by a differentiable Newton step from
    the recorded root (the rodas_adjoint event mechanics). Combines with
    t_eval (the radau_adjoint convention): returns
    ``(ys [M,T,D], y_term [M,D], t_term [M])`` (+ q with ``cost``) where
    samples past a lane's t* are NaN — the forward solvers' truncation
    convention — and a triggered lane's later segments collapse to
    zero-length solves so the triggering segment's event pull carries the
    whole gradient; mask the NaN samples out of the loss (e.g.
    ``jnp.where(jnp.isfinite(ys), (ys − data)**2, 0)``). The
    event-truncated trajectory-fitting loss is the canonical
    neural-ODE-with-stopping workload.

    cost: optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
    (or ``[M, Q]``). Appends ``q = ∫ l dt`` (``solve_ivp(quad=...)``, the
    CVODES quadrature role) to the outputs — ``(y, q)``, ``(ys, q)`` with
    t_eval (q summed over the grid span), ``(y, t_term, q)`` with events
    (q truncated at t*) — and q's cotangent flows through the SAME
    backward sweep: each recorded step's replay also rebuilds its dense
    interpolant and recomputes the GL-3 quadrature increment
    (bit-identical to the forward accumulation), so q̄ pulls are exact
    discrete-adjoint gradients of the computed q. Integral-cost (Lagrange)
    objectives — the standard neural-ODE regularized-training shape — at
    one backward sweep, no state augmentation; reverse twin of the CVODES
    quadrature sensitivities (reference
    examples/cpp/for_sens_vdp_example.cpp:1-38).
    """
    if method not in TABLEAUS:
        raise ValueError(f"dopri_adjoint: unknown method {method!r}; "
                         f"choose from {sorted(TABLEAUS)}")
    tab = TABLEAUS[method]
    opts = options if options is not None else Options()
    from janus_tpu.solve.events import normalize_events
    specs = normalize_events(events)
    if specs:
        if not all(e.terminal for e in specs):
            raise ValueError("dopri_adjoint(events=...) requires every "
                             "event terminal (non-terminal recordings "
                             "have no gradient contract)")
    cap = opts.adjoint_steps
    use_cost = cost is not None

    t0_in, tf_in = tspan

    @jax.custom_vjp
    def run(t0, tf, y0, args, h0):
        sol = solve_erk(tab, f, t0, tf, y0, args, opts,
                        events=events or None, quad=cost, _h0=h0)
        if specs:
            outs = (sol.y, sol.t, sol.h_next, sol.event_idx)
        else:
            outs = (sol.y, sol.h_next)
        return outs + ((sol.quad,) if use_cost else ())

    def fwd(t0, tf, y0, args, h0):
        sol = solve_erk(tab, f, t0, tf, y0, args, opts,
                        events=events or None, quad=cost, _mesh_size=cap,
                        _h0=h0)
        res = (sol.mesh, sol.stats["naccept"], t0, tf,
               y0, args, sol.y, sol.t, h0,
               sol.event_idx if specs else None)
        if specs:
            outs = (sol.y, sol.t, sol.h_next, sol.event_idx)
        else:
            outs = (sol.y, sol.h_next)
        return outs + ((sol.quad,) if use_cost else ()), res

    def bwd(res, out_bar):
        qbar_in = out_bar[-1] if use_cost else None
        if use_cost:
            out_bar = out_bar[:-1]
        if specs:
            ybar, tbar_in, _, _ = out_bar    # h_next/event_idx: knobs
        else:
            ybar, _ = out_bar            # h_next is a non-differentiable knob
        mesh, nacc, t0, tf, y0, args, yT, t_end, h0, ev_idx = res
        t0b, tfb, y0b = cm.broadcast_batch(t0, tf, y0)
        m, dim = y0b.shape
        dtype = y0b.dtype
        ybar = jnp.asarray(ybar, dtype)

        dleaves, rebuild, leaves, treedef, diff_idx = _split_diff(args)

        def fa(t, y, dl):
            return f(t, y, rebuild(dl))

        if use_cost:
            def lfun(t, y, dl):                        # canon [M, Q]
                return cm.canon_cost(cost(t, y, rebuild(dl)))

            qb = jnp.asarray(qbar_in, dtype)
            qb = qb if qb.ndim == 2 else qb[:, None]   # [M, Q]

        def step(t, h, y, dl, live):
            if not use_cost:
                return _one_step(tab, fa, t, h, y, dl, live=live)
            y1, interp = _one_step(tab, fa, t, h, y, dl, live=live,
                                   want_interp=True)
            q_inc = _gl3_inc(lambda tt, yy: lfun(tt, yy, dl), t, h,
                             interp, jnp.ones_like(t))
            return y1, q_inc

        gl0 = [jnp.zeros(jnp.shape(l), dtype) for l in dleaves]

        if specs:
            triggered = ev_idx >= 0
            tbar = jnp.asarray(tbar_in, dtype)

            def g_sel(t, y, dl):
                # the lane's OWN terminating event function (one-hot over
                # the spec list by the recorded event_idx)
                a = rebuild(dl)
                vals = jnp.stack([jnp.asarray(e.fn(t, y, a), dtype)
                                  for e in specs], axis=0)      # [K, M]
                oh = (jnp.arange(len(specs))[:, None]
                      == jnp.maximum(ev_idx, 0)[None, :]).astype(dtype)
                return jnp.sum(oh * vals, axis=0)

            def evt_endpoint(t, h, y, dl, th0, live):
                # (y*, t*) of the triggering step as a differentiable map:
                # replay the step + its dense interpolant and re-polish θ*
                # by TWO Newton iterations from the recorded root (starting
                # converged, the polished iterate's derivative equals the
                # implicit-function derivative to O(residual²))
                _, interp = _one_step(tab, fa, t, h, y, dl, live=live,
                                      want_interp=True)

                def yi(th):
                    return interp(th[:, None])[:, 0]

                def gfun(th):
                    return g_sel(t + th * h, yi(th), dl)

                th = th0
                for _ in range(2):
                    gv, dg = jax.jvp(gfun, (th,), (jnp.ones_like(th),))
                    th = th - gv / jnp.where(dg == 0.0, 1.0, dg)
                outs = (yi(th), t + th * h)
                if use_cost:
                    # the lane's LAST quadrature increment truncates at θ*
                    # (the forward's event-lane convention), so dq/dt*
                    # also falls out of the vjp
                    outs = outs + (_gl3_inc(
                        lambda tt, yy: lfun(tt, yy, dl), t, h, interp,
                        th),)
                return outs

        def body(carry, k):
            lam, gl = carry
            live = k < nacc                                   # [M]
            # dead slots hold zeros; substitute a benign step whose
            # (masked) replay is the identity — its pull sees a zero
            # cotangent and contributes exact zeros. NOT cond-gated: the
            # explicit replay is a handful of fused elementwise ops, far
            # below a per-iteration cond's dispatch overhead (the inverse
            # of the radau-adjoint regime where per-slot LU work is large);
            # unroll amortizes the remaining per-iteration scan overhead.
            tk = jnp.where(live, mesh["t"][:, k], t0b)
            hk = jnp.where(live, mesh["h"][:, k], 1.0)
            yk = jnp.where(live[:, None], mesh["y"][:, k], y0b)
            lam_in = jnp.where(live[:, None], lam, 0.0)
            if specs:
                # the triggering lane's LAST live slot carries the whole
                # (ȳ*, t̄*) cotangent through the event endpoint instead
                # of the plain step map
                is_evt = live & triggered & (k == nacc - 1)
                lam_in = jnp.where(is_evt[:, None], 0.0, lam_in)
            _, pull = jax.vjp(
                lambda yy, dl: step(tk, hk, yy, dl, live), yk, dleaves)
            if use_cost:
                # each live step's replayed quadrature increment takes the
                # whole q̄ (q = Σ increments); the triggering lane's last
                # slot accumulated its (truncated) increment through
                # evt_endpoint instead
                qb_k = jnp.where(live[:, None], qb, 0.0)
                if specs:
                    qb_k = jnp.where(is_evt[:, None], 0.0, qb_k)
                dy, dgl = pull((lam_in, qb_k))
            else:
                dy, dgl = pull(lam_in)
            if specs:
                th0 = jnp.clip(
                    (t_end - tk) / jnp.where(hk == 0.0, 1.0, hk), 0.0, 1.0)
                th0 = jnp.where(is_evt, th0, 0.5)

                def do_evt(_):
                    _, pull_e = jax.vjp(
                        lambda yy, dl: evt_endpoint(tk, hk, yy, dl, th0,
                                                    live), yk, dleaves)
                    ct = (jnp.where(is_evt[:, None], lam, 0.0),
                          jnp.where(is_evt, tbar, 0.0))
                    if use_cost:
                        ct = ct + (jnp.where(is_evt[:, None], qb, 0.0),)
                    return pull_e(ct)

                dye, dgle = jax.lax.cond(
                    jnp.any(is_evt), do_evt,
                    lambda _: (jnp.zeros_like(lam),
                               [jnp.zeros(jnp.shape(l), dtype)
                                for l in dleaves]), None)
                dy = dy + jnp.where(is_evt[:, None], dye, 0.0)
                dgl = [g + ge for g, ge in zip(dgl, dgle)]
            return (jnp.where(live[:, None], dy, lam),
                    [g + dg for g, dg in zip(gl, dgl)]), None

        (lam0, gl), _ = jax.lax.scan(
            body, (ybar, gl0), jnp.arange(cap - 1, -1, -1), unroll=8)

        # overflow: a lane that accepted more steps than the ring holds has
        # an incomplete mesh — poison its gradient (and shared-leaf grads)
        over = nacc > cap                                     # [M]
        lam0 = jnp.where(over[:, None], jnp.nan, lam0)
        any_over = jnp.any(over)
        gl = [jnp.where(any_over, jnp.nan, g) for g in gl]

        tf_bar = jnp.sum(ybar * fa(t_end, yT, dleaves), axis=-1)    # [M]
        if use_cost:
            # the quadrature endpoint moves with tf: dq/dT = l(T, y(T))
            tf_bar = tf_bar + jnp.sum(qb * lfun(t_end, yT, dleaves),
                                      axis=-1)
        if specs:
            # triggered lanes stop at t* < tf (frozen mesh: tf moves
            # nothing; the (ȳ*, t̄*, q̄) pull went through the event
            # endpoint); non-triggered lanes return t = tf exactly
            tf_bar = jnp.where(triggered, 0.0, tf_bar + tbar)
        t0_bar = -jnp.sum(lam0 * fa(t0b, y0b, dleaves), axis=-1)    # [M]
        if use_cost:
            t0_bar = t0_bar - jnp.sum(qb * lfun(t0b, y0b, dleaves),
                                      axis=-1)

        t0_ct = jnp.sum(t0_bar) if jnp.ndim(t0) == 0 else \
            jnp.reshape(t0_bar, jnp.shape(t0))
        tf_ct = jnp.sum(tf_bar) if jnp.ndim(tf) == 0 else \
            jnp.reshape(tf_bar, jnp.shape(tf))
        y0_ct = jnp.reshape(lam0, jnp.shape(y0))
        out = [np.zeros(jnp.shape(l), jax.dtypes.float0) for l in leaves]
        for i, g in zip(diff_idx, gl):
            out[i] = jnp.reshape(g, jnp.shape(leaves[i]))
        args_ct = jax.tree_util.tree_unflatten(treedef, out)
        h0_ct = None if h0 is None else jnp.zeros_like(h0)
        return (t0_ct, tf_ct, y0_ct, args_ct, h0_ct)

    run.defvjp(fwd, bwd)

    if t_eval is None:
        if specs:
            if use_cost:
                y, t_term, _, _, q = run(t0_in, tf_in, y0, args, None)
                return y, t_term, q
            y, t_term, _, _ = run(t0_in, tf_in, y0, args, None)
            return y, t_term
        if use_cost:
            y, _, q = run(t0_in, tf_in, y0, args, None)
            return y, q
        y, _ = run(t0_in, tf_in, y0, args, None)
        return y

    if jnp.ndim(t0_in) != 0 or jnp.ndim(tf_in) != 0:
        raise ValueError("dopri_adjoint(t_eval=...) chains segments over a "
                         "shared grid; t0/tf must be scalars")
    t_eval = jnp.asarray(t_eval)
    if t_eval.ndim != 1 or t_eval.shape[0] < 1:
        raise ValueError("t_eval must be a non-empty 1-D grid")
    t0b, _, y0b = cm.broadcast_batch(t0_in, tf_in, y0)
    dtype = y0b.dtype
    t_eval = t_eval.astype(dtype)
    t_lo = jnp.concatenate([jnp.full((1,), t0_in, dtype), t_eval[:-1]])
    t_hi = t_eval
    h_carry0 = jnp.zeros(t0b.shape, dtype)     # 0 ⇒ automatic initial step

    if specs:
        # events + t_eval: chain the sample segments per lane; once a lane
        # triggers, its later segments are ZERO-LENGTH solves t* → t* (the
        # identity — their boundary cotangents cancel, so the event pull
        # applied in the triggering segment's backward pass carries the
        # whole gradient). Samples past t* are NaN (the forward solvers'
        # truncation convention); the sample exactly AT t* (a trigger on a
        # segment boundary) stays valid. The radau_adjoint convention
        # (solve/adjoint.py seg_ev).
        m = y0b.shape[0]
        done0 = jnp.zeros((m,), bool)
        tstar0 = jnp.full((m,), t0_in, dtype)
        nan = jnp.asarray(jnp.nan, dtype)
        if use_cost:
            q0 = jnp.zeros(jax.eval_shape(
                lambda: cost(t0b, y0b, args)).shape, dtype)

        def seg_ev(carry, bounds):
            if use_cost:
                y, h, done, tstar, q = carry
            else:
                y, h, done, tstar = carry
            ta, tb = bounds
            ta_l = jnp.where(done, tstar, jnp.full((m,), ta, dtype))
            tb_l = jnp.where(done, tstar, jnp.full((m,), tb, dtype))
            outs = run(ta_l, tb_l, y, args, h)
            if use_cost:
                y2, t2, h2, idx2, q2 = outs
            else:
                y2, t2, h2, idx2 = outs
            trig = (idx2 >= 0) & ~done
            tstar2 = jnp.where(trig, t2, tstar)
            done2 = done | trig
            # a trigger strictly inside the segment invalidates the
            # segment's endpoint sample; a trigger exactly at tb keeps it
            dead = done | (trig & (t2 != tb_l))
            sample = jnp.where(dead[:, None], nan, y2)
            if use_cost:
                return (y2, h2, done2, tstar2, q + q2), sample
            return (y2, h2, done2, tstar2), sample

        if use_cost:
            (yF, _, doneF, tstarF, q), ys = jax.lax.scan(
                seg_ev, (y0b, h_carry0, done0, tstar0, q0), (t_lo, t_hi))
        else:
            (yF, _, doneF, tstarF), ys = jax.lax.scan(
                seg_ev, (y0b, h_carry0, done0, tstar0), (t_lo, t_hi))
        ys = jnp.swapaxes(ys, 0, 1)                    # [M, T, D]
        t_term = jnp.where(doneF, tstarF,
                           jnp.broadcast_to(t_eval[-1], (m,)))
        if use_cost:
            return ys, yF, t_term, q
        return ys, yF, t_term

    if use_cost:
        q0 = jnp.zeros(jax.eval_shape(
            lambda: cost(t0b, y0b, args)).shape, dtype)

        def seg_q(carry, bounds):
            y, h, q = carry
            y2, h2, q2 = run(bounds[0], bounds[1], y, args, h)
            return (y2, h2, q + q2), y2

        (_, _, q), ys = jax.lax.scan(seg_q, (y0b, h_carry0, q0),
                                     (t_lo, t_hi))
        return jnp.swapaxes(ys, 0, 1), q       # [M, T, D], [M(, Q)]

    def seg(carry, bounds):
        y, h = carry
        y2, h2 = run(bounds[0], bounds[1], y, args, h)
        return (y2, h2), y2

    (_, _), ys = jax.lax.scan(seg, (y0b, h_carry0), (t_lo, t_hi))
    return jnp.swapaxes(ys, 0, 1)              # [M, T, D]
