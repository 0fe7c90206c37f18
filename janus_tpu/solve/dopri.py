"""Explicit Dormand–Prince solvers (Dopri5, Dopri853) — batched lockstep.

Re-designs the reference's Dopri853TeD (src/cpp/dopri853ted.hpp:26-734,
src/python/dopri853ted.py) the batched way: a single ``lax.while_loop`` advances the
whole batch; per-trajectory accept/reject, PI step control
(reference control(): dopri853ted.hpp:523), and termination are ``jnp.where``
selects on [M] masks instead of index_put_ scatter (dopri853ted.py:416-433).

Butcher tableaus and dense-output coefficient matrices are taken from scipy's
published arrays (scipy.integrate._ivp.rk / dop853_coefficients) — mathematical
constants, not reference code.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

# f32 einsums must not run at reduced precision (TF32 on the GPU)
_EINSUM_PRECISION = jax.lax.Precision.HIGHEST
import numpy as np

from janus_tpu.solve import common as cm
from janus_tpu.solve.events import (eval_events, handle_events,
                                    init_event_state, normalize_events)
from janus_tpu.solve.options import Options
from janus_tpu.diag.record import init_dyn, record_step


class ERKTableau:
    """Static explicit-RK tableau (trace-time constants)."""

    def __init__(self, name, a, b, c, order, expo1, *, e=None, e3=None, e5=None,
                 dense="hermite", p=None, a_extra=None, c_extra=None, d=None,
                 default_beta=0.0):
        self.name = name
        self.a = np.asarray(a)
        self.b = np.asarray(b)
        self.c = np.asarray(c)
        self.e = None if e is None else np.asarray(e)
        self.e3 = None if e3 is None else np.asarray(e3)
        self.e5 = None if e5 is None else np.asarray(e5)
        self.order = order
        self.expo1 = expo1          # error exponent (1/(q+1))
        self.n_stages = len(self.b)
        self.dense = dense          # 'rk45P' | 'dop853D' | 'hermite'
        self.p = None if p is None else np.asarray(p)
        self.a_extra = None if a_extra is None else np.asarray(a_extra)
        self.c_extra = None if c_extra is None else np.asarray(c_extra)
        self.d = None if d is None else np.asarray(d)
        self.default_beta = default_beta


def _tableaus():
    from scipy.integrate._ivp import rk as srk
    from scipy.integrate._ivp import dop853_coefficients as dc

    dopri5 = ERKTableau(
        "dopri5", srk.RK45.A, srk.RK45.B, srk.RK45.C, order=5, expo1=0.2,
        e=srk.RK45.E, dense="rk45P", p=srk.RK45.P, default_beta=0.04,
    )
    ns = dc.N_STAGES  # 12
    dopri853 = ERKTableau(
        "dopri853", dc.A[:ns, :ns], dc.B, dc.C[:ns], order=8, expo1=1.0 / 8.0,
        e3=srk.DOP853.E3, e5=srk.DOP853.E5, dense="dop853D",
        a_extra=dc.A[ns + 1:], c_extra=dc.C[ns + 1:], d=dc.D,
        default_beta=0.0,
    )
    return {"dopri5": dopri5, "dopri853": dopri853}


TABLEAUS = _tableaus()


@struct.dataclass
class _ERKState:
    t: jnp.ndarray
    y: jnp.ndarray
    f0: jnp.ndarray          # FSAL first-stage derivative
    h: jnp.ndarray           # signed step size
    facold: jnp.ndarray      # PI controller memory
    active: jnp.ndarray
    status: jnp.ndarray
    stats: dict
    out_ys: Any              # [M,T,D] or 0 (disabled)
    ev: Any                  # event-detection state dict
    dyn: Any                 # per-step playback (DynTe role)
    mesh: Any                # accepted-step rings for the discrete adjoint
    q_acc: Any               # [M, Q] running-cost quadrature (0-d unused)


def _stages(tab: ERKTableau, f, t, y, h, f0, args):
    """Evaluate the RK stages; returns K list of n_stages+1 arrays (incl. f_new)
    and the step solution y1."""
    ks = [f0]
    for i in range(1, tab.n_stages):
        acc = ks[0] * tab.a[i, 0]
        for j in range(1, i):
            if tab.a[i, j] != 0.0:
                acc = acc + ks[j] * tab.a[i, j]
        yi = y + h[:, None] * acc
        ks.append(f(t + tab.c[i] * h, yi, args))
    acc = None
    for j in range(tab.n_stages):
        if tab.b[j] != 0.0:
            term = ks[j] * tab.b[j]
            acc = term if acc is None else acc + term
    y1 = y + h[:, None] * acc
    f_new = f(t + h, y1, args)
    ks.append(f_new)
    return ks, y1, f_new


def _err_norm(tab: ERKTableau, ks, h, y, y1, rtol, atol):
    sc = atol + rtol * jnp.maximum(jnp.abs(y), jnp.abs(y1))
    if tab.e is not None:
        err = None
        for j, ej in enumerate(tab.e):
            if ej != 0.0:
                term = ks[j] * ej
                err = term if err is None else err + term
        return cm.rms_norm(h[:, None] * err, sc)
    # DOP853 combined 5th/3rd estimate (Hairer; cf. reference
    # dopri853ted.hpp:273-298 'error()')
    def comb(evec):
        acc = None
        for j, ej in enumerate(evec):
            if ej != 0.0:
                term = ks[j] * ej
                acc = term if acc is None else acc + term
        return acc / sc
    e5 = comb(tab.e5)
    e3 = comb(tab.e3)
    e5sq = jnp.sum(jnp.square(e5), axis=-1)
    e3sq = jnp.sum(jnp.square(e3), axis=-1)
    denom = e5sq + 0.01 * e3sq
    denom = jnp.where(denom <= 0.0, 1.0, denom)
    n = y.shape[-1]
    return jnp.abs(h) * e5sq / jnp.sqrt(denom * n)


def _dop853_power_matrix():
    """Constant map from the dop853 ``fall`` rows to the shared power
    basis: the dense interpolant's alternating (θ, 1−θ) Horner cascade is
    a degree-7 polynomial LINEAR in the 7 fall coefficients, so expanding
    the products symbolically (coefficient arrays, lowest power first)
    gives an exact [7 fall-rows, 7 powers θ¹..θ⁷] matrix with
    binomial-scale entries — f32-safe, unlike a Vandermonde re-fit
    (measured 1e-3 f32 error from the degree-7 node fit this replaces)."""
    a = np.zeros((7, 8))
    for i in range(7):
        a[6 - i, 0] += 1.0
        if i % 2 == 0:                       # acc *= θ  (shift powers up)
            a = np.roll(a, 1, axis=1)
            a[:, 0] = 0.0
        else:                                # acc *= (1 − θ)
            sh = np.roll(a, 1, axis=1)
            sh[:, 0] = 0.0
            a = a - sh
    assert np.allclose(a[:, 0], 0.0)         # p(0) = y: no constant term
    return a[:, 1:]


_DOP853_POW = _dop853_power_matrix()


def _dense_eval_rk45(tab, ks, y, h):
    k = jnp.stack(ks, axis=1)                       # [M, 7, D]
    q = jnp.einsum("msd,sq->mqd", k, jnp.asarray(tab.p, k.dtype), precision=_EINSUM_PRECISION)

    def interp(theta):                               # [M, T] -> [M, T, D]
        npow = tab.p.shape[1]
        tp = jnp.stack([theta ** (i + 1) for i in range(npow)], axis=-1)
        return y[:, None, :] + h[:, None, None] * jnp.einsum(
            "mtq,mqd->mtd", tp, q, precision=_EINSUM_PRECISION)

    return interp


def _dop853_fall(tab, f, t, y, y1, f_new, h, ks, args):
    """Order-7 interpolant coefficient tensor [M,7,D] (3 extra f evals)."""
    k_ext = list(ks[:-1]) + [f_new]
    for arow, c in zip(tab.a_extra, tab.c_extra):
        acc = None
        for j in range(len(k_ext)):
            if arow[j] != 0.0:
                term = k_ext[j] * arow[j]
                acc = term if acc is None else acc + term
        yi = y + h[:, None] * acc
        k_ext.append(f(t + c * h, yi, args))
    kmat = jnp.stack(k_ext, axis=1)                  # [M, 16, D]
    delta = y1 - y
    f_old = ks[0]
    fpoly = [delta,
             h[:, None] * f_old - delta,
             2.0 * delta - h[:, None] * (f_new + f_old)]
    rest = jnp.einsum("qs,msd->mqd", jnp.asarray(tab.d, kmat.dtype), kmat, precision=_EINSUM_PRECISION)
    fstack = jnp.stack(fpoly, axis=1)
    return jnp.concatenate([fstack, h[:, None, None] * rest], axis=1)


def _dense_eval_dop853(fall, y):
    def interp(theta):                               # [M, T] -> [M, T, D]
        x = theta[..., None]
        acc = jnp.zeros(x.shape[:-1] + (y.shape[-1],), y.dtype)
        npoly = fall.shape[1]
        for i in range(npoly):
            fcomp = fall[:, npoly - 1 - i, :][:, None, :]
            acc = acc + fcomp
            acc = acc * (x if i % 2 == 0 else 1.0 - x)
        return acc + y[:, None, :]

    return interp


def solve_erk(tab: ERKTableau, f: Callable, t0, tf, y0, args=None,
              options: Optional[Options] = None, t_eval=None,
              events=None, step_args=None,
              quad: Optional[Callable] = None, dense: int = 0,
              _mesh_size: int = 0, _h0=None) -> cm.Solution:
    """Integrate a batch with an explicit RK method under one lax.while_loop.

    quad: optional running-cost integrand ``l(t[M], y[M,D], args) -> [M]``
    (or ``[M, Q]``); ``Solution.quad`` accumulates ∫ l dt per accepted step
    by 3-point Gauss-Legendre on the method's own dense interpolant (the
    scipy-RK45-quartic / dop853 degree-7 continuous extension), truncated
    at t* on event-terminated lanes — the CVODES quadrature-integration
    role on the explicit family.

    dense: step-mesh capacity N > 0: store each accepted step's interpolant
    expanded EXACTLY into the shared power basis (rk45's dense form is
    already power-basis; dop853's mixed (θ, 1−θ) Horner cascade maps
    through a constant binomial-scale matrix — no node re-fitting, so the
    expansion is f32-safe) and ``Solution.interpolate(ts)``
    evaluates the solution anywhere post hoc (scipy's ``sol.sol(t)`` role
    on RK45/DOP853). Size N above the worst lane's step count; overflowing
    lanes interpolate to NaN.

    step_args: optional pytree of per-ACCEPTED-step parameter slabs — the
    reference's exact adaptive-stepper semantics (dopri853ted.hpp:302-308
    ``theta`` sliced by the step count; exhaustion error :658-666). Every
    leaf has leading axis S (the slab count); a lane's k-th accepted step
    evaluates ALL its stages with row k, passed to f as ``(args, slab_k)``
    (the odeint_fixed convention). Leaves whose SECOND axis equals the
    batch size M are treated as per-lane slab tables [S, M, ...] (the
    reference's per-lane theta layout). A lane still running after its
    S-th accepted step fails with status PARAMS_EXHAUSTED — made per-lane
    instead of a host-side throw. Slabs select by one-hot contraction (no
    gathers in the hot loop) on each lane's OWN accept count; event
    functions still receive the plain ``args``. Stage 0 is re-evaluated
    each attempt (FSAL reuse would leak the previous step's slab across
    the boundary). For time-indexed controls prefer
    ``models.controls.piecewise_constant`` — step-indexed slabs couple the
    parameterization to the mesh the controller happens to choose.

    _mesh_size / _h0 are internal (solve/adjoint_dopri.py): record
    (t, h, y) rings of the accepted steps for the discrete adjoint's
    frozen-mesh step replay, and warm-start the per-lane initial step for
    segment chaining. The replay is bit-exact without any forward-pass
    change: the FSAL derivative s.f0 always equals a fresh f(t, y) at the
    step start (f_new was evaluated at exactly that point when the previous
    step was accepted), so the replay's fresh stage-0 evaluation reproduces
    the forward stages exactly.
    """
    opts = options if options is not None else Options()
    specs = normalize_events(events)
    t0, tf, y0 = cm.broadcast_batch(t0, tf, y0)
    m, dim = y0.shape
    dtype = y0.dtype

    use_quad = quad is not None
    if use_quad:
        qshape = jax.eval_shape(lambda: quad(t0, y0, args)).shape
        if len(qshape) not in (1, 2) or qshape[0] != m:
            raise ValueError(f"quad must return [M] or [M, Q] with M={m}, "
                             f"got {qshape}")
        quad_scalar = len(qshape) == 1
        qdim = 1 if quad_scalar else qshape[1]

        def _ql(t, y):
            return cm.canon_cost(quad(t, y, args))

    store_q = bool(dense)
    mesh_size = max(int(_mesh_size), int(dense))
    store_mesh = bool(mesh_size)
    n_pow = 4 if tab.dense == "rk45P" else 7

    use_slabs = step_args is not None
    if use_slabs:
        if _mesh_size:
            raise ValueError("step_args= does not compose with the discrete "
                             "adjoint (the replay has no slab index); use "
                             "time-indexed controls "
                             "(models.controls.piecewise_constant) for "
                             "reverse mode")
        n_slabs, slab_at = cm.make_slab_selector(step_args, m, dtype)
    # beta < 0 (the Options default) means "use the method's own default"
    # (0.04 for dopri5, 0.0 for dop853, Hairer's choices)
    beta = opts.beta if opts.beta >= 0 else tab.default_beta
    # Hairer: dopri5 expo1 = 0.2 - beta*0.75; dop853 expo1 = 1/8 - beta*0.2
    if tab.name == "dopri5":
        expo1 = 0.2 - beta * 0.75
    else:
        expo1 = 1.0 / 8.0 - beta * 0.2

    args0 = (args, slab_at(jnp.zeros((m,), jnp.int32))) if use_slabs else args
    f0 = f(t0, y0, args0)
    if _h0 is not None:
        # per-lane warm-start step (segment chaining, solve/adjoint_dopri):
        # lanes with _h0 == 0 fall back to the automatic initial step
        direction = jnp.where(tf >= t0, 1.0, -1.0).astype(dtype)
        h_mag = jnp.abs(jnp.broadcast_to(jnp.asarray(_h0, dtype), (m,)))
        h_auto = jnp.abs(cm.initial_step(f, t0, y0, f0, tf, tab.order,
                                         opts.rtol, opts.atol, args0,
                                         opts.max_step))
        h_mag = jnp.where(h_mag > 0, h_mag, h_auto)
        h = jnp.minimum(h_mag, jnp.abs(tf - t0)) * direction
    elif opts.h0 == 0.0:
        h = cm.initial_step(f, t0, y0, f0, tf, tab.order, opts.rtol, opts.atol,
                            args0, opts.max_step)
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

    stats = cm.zero_stats(m, ("nfev", "nsteps", "naccept", "nreject"))
    stats["nfev"] = stats["nfev"] + 2  # f0 + hinit probe
    already_done = t0 == tf
    state = _ERKState(
        t=t0, y=y0, f0=f0, h=h,
        facold=jnp.full((m,), 1e-4, dtype),
        active=~already_done,
        status=jnp.where(already_done, cm.SUCCESS, cm.RUNNING).astype(jnp.int8),
        stats=stats, out_ys=out_ys,
        ev=init_event_state(specs, m, dim, t0, y0, args, dtype),
        dyn=init_dyn(m, opts.record_steps, dtype),
        mesh=dict(
            {"t": jnp.zeros((m, mesh_size), dtype),
             "h": jnp.zeros((m, mesh_size), dtype),
             "y": jnp.zeros((m, mesh_size, dim), dtype)},
            **({"q": jnp.zeros((m, mesh_size, n_pow, dim), dtype)}
               if store_q else {}))
        if store_mesh else {},
        q_acc=jnp.zeros((m, qdim), dtype) if use_quad
        else jnp.zeros((), dtype),
    )

    eps = jnp.finfo(dtype).eps
    facc1 = 1.0 / opts.min_factor
    facc2 = 1.0 / opts.max_factor

    def cond(s):
        return jnp.any(s.active)

    def body(s):
        remaining = tf - s.t
        last = jnp.abs(s.h) >= jnp.abs(remaining)
        h = jnp.where(last, remaining, s.h)
        h = jnp.where(h == 0.0, eps, h)  # finished lanes: dummy nonzero

        if use_slabs:
            # a lane's k-th accepted step runs on slab row k; stage 0 is
            # re-evaluated so the previous step's slab can't leak in
            # through the FSAL derivative
            exhausted = s.active & (s.stats["naccept"] >= n_slabs)
            fa = (args, slab_at(s.stats["naccept"]))
            f0_use = f(s.t, s.y, fa)
        else:
            exhausted = jnp.zeros((m,), bool)
            fa = args
            f0_use = s.f0

        ks, y1, f_new = _stages(tab, f, s.t, s.y, h, f0_use, fa)
        enorm = _err_norm(tab, ks, h, s.y, y1, opts.rtol, opts.atol)
        enorm = jnp.where(jnp.isfinite(enorm), enorm, 1e10)
        enorm = jnp.maximum(enorm, 1e-16)
        accept = enorm <= 1.0

        # Hairer PI controller
        fac11 = enorm ** expo1
        fac = fac11 / (s.facold ** beta)
        fac = jnp.maximum(facc2, jnp.minimum(facc1, fac / opts.safety))
        hnew_acc = h / fac
        hnew_acc = jnp.clip(jnp.abs(hnew_acc), 0.0, opts.max_step) * jnp.sign(hnew_acc)
        hnew_rej = h / jnp.minimum(facc1, fac11 / opts.safety)
        hnew = jnp.where(accept, hnew_acc, hnew_rej)

        upd = accept & s.active & ~exhausted
        done = upd & last

        out_ys = s.out_ys
        interp = None
        if use_dense or specs or use_quad or store_q:
            if tab.dense == "rk45P":
                interp = _dense_eval_rk45(tab, ks, s.y, h)
            else:
                # the 3 extra interpolation stages are expensive optional
                # work: gate on any lane actually accepting this step
                fall = jax.lax.cond(
                    jnp.any(upd),
                    lambda _: _dop853_fall(tab, f, s.t, s.y, y1, f_new, h,
                                           ks, fa),
                    lambda _: jnp.zeros((m, 7, dim), dtype),
                    operand=None)
                interp = _dense_eval_dop853(fall, s.y)
        if use_dense:
            out_ys = cm.collect_dense(out_ys, t_eval, s.t, h, upd, interp)

        ev, terminate, t_ev, y_ev, _ev_idx = handle_events(
            specs, s.ev, s.t, h, s.y, s.t + h, y1, interp, upd, args)
        if use_dense and specs:
            out_ys = cm.mask_dense_after_event(out_ys, t_eval, terminate,
                                               t_ev, h)

        if use_quad:
            q_acc = cm.quad_gl3_step(_ql, s.t, h, interp, upd, terminate,
                                     t_ev, s.q_acc)
        else:
            q_acc = s.q_acc

        dyn = record_step(s.dyn, s.active, s.t, h, enorm,
                          jnp.zeros_like(s.stats["nsteps"]), accept)

        if store_mesh:
            rows = jnp.arange(m)
            idx = s.stats["naccept"]
            af = upd.astype(dtype)
            mesh = {
                "t": s.mesh["t"].at[rows, idx].add(af * s.t, mode="drop"),
                "h": s.mesh["h"].at[rows, idx].add(af * h, mode="drop"),
                "y": s.mesh["y"].at[rows, idx].add(
                    af[:, None] * s.y, mode="drop"),
            }
            if store_q:
                # expand the step interpolant into the shared power basis
                # EXACTLY: rk45's dense form is already power-basis
                # (y + h Σ θ^{p+1}(kᵀP)_p); dop853's Horner cascade maps
                # through the constant _DOP853_POW matrix. where, not af*:
                # non-accepting lanes can carry NaN stage values and 0·NaN
                # poisons dead slots the interpolate one-hot still touches
                # (CLAUDE.md round-4 mesh rule)
                if tab.dense == "rk45P":
                    kmat = jnp.stack(ks, axis=1)
                    qrows = h[:, None, None] * jnp.einsum(
                        "msd,sq->mqd", kmat, jnp.asarray(tab.p, dtype),
                        precision=_EINSUM_PRECISION)
                else:
                    qrows = jnp.einsum(
                        "jp,mjd->mpd", jnp.asarray(_DOP853_POW, dtype),
                        fall, precision=_EINSUM_PRECISION)
                mesh["q"] = s.mesh["q"].at[rows, idx].add(
                    jnp.where(upd[:, None, None], qrows, 0.0), mode="drop")
        else:
            mesh = s.mesh

        t_n = jnp.where(upd, jnp.where(terminate, t_ev, s.t + h), s.t)
        y_n = jnp.where(upd[:, None],
                        jnp.where(terminate[:, None], y_ev, y1), s.y)
        f0_n = jnp.where(upd[:, None], f_new, s.f0)
        facold_n = jnp.where(upd, jnp.maximum(enorm, 1e-4), s.facold)
        h_n = jnp.where(s.active, hnew, s.h)

        stats = dict(s.stats)
        # dop853 interpolant costs 3 extra f evals per accepted step whenever
        # it is built (dense output OR event detection)
        nf_extra = 3 if ((use_dense or specs or use_quad or store_q)
                         and tab.dense == "dop853D") else 0
        stats["nfev"] = stats["nfev"] + s.active * (tab.n_stages + 1) \
            + upd * nf_extra + (s.active if use_slabs else 0)
        stats["nsteps"] = stats["nsteps"] + s.active
        stats["naccept"] = stats["naccept"] + upd
        stats["nreject"] = stats["nreject"] + (s.active & ~accept)

        exceeded = s.active & (stats["nsteps"] >= opts.max_steps) & ~done
        # Hairer's t-relative underflow test (cf. solve/radau.py)
        underflow = s.active & (0.1 * jnp.abs(h_n) <= eps * jnp.abs(t_n)) \
            & ~done & ~exceeded

        status = s.status
        status = jnp.where(done, cm.SUCCESS, status).astype(jnp.int8)
        status = jnp.where(exceeded, cm.MAX_STEPS, status).astype(jnp.int8)
        status = jnp.where(underflow, cm.STEP_UNDERFLOW, status).astype(jnp.int8)
        status = jnp.where(exhausted, cm.PARAMS_EXHAUSTED,
                           status).astype(jnp.int8)
        status = jnp.where(terminate, cm.EVENT_TERMINATED, status).astype(jnp.int8)
        active = (s.active & ~done & ~exceeded & ~underflow & ~terminate
                  & ~exhausted)

        return _ERKState(t=t_n, y=y_n, f0=f0_n, h=h_n, facold=facold_n,
                         active=active, status=status, stats=stats,
                         out_ys=out_ys, ev=ev, dyn=dyn, mesh=mesh,
                         q_acc=q_acc)

    final = jax.lax.while_loop(cond, body, state)
    return cm.Solution(
        t=final.t, y=final.y, status=final.status, stats=final.stats,
        ts=t_eval if use_dense else None,
        ys=final.out_ys if use_dense else None,
        event_t=final.ev["event_t"] if specs else None,
        event_y=final.ev["event_y"] if specs else None,
        event_idx=final.ev["event_idx"] if specs else None,
        dyn=final.dyn,
        mesh=final.mesh if store_mesh else None,
        quad=(final.q_acc[:, 0] if quad_scalar else final.q_acc)
        if use_quad else None,
        h_next=final.h,
    )
