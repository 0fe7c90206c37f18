"""Shared machinery for the lockstep masked solvers.

The reference emulates per-trajectory continue/break with boolean masks and
index_put_ (reference src/cpp/radaute_impl.hpp:549-560,704;
src/python/seulexted.py:314-353). Here the whole batch advances under one
``lax.while_loop`` and every per-trajectory decision is a ``jnp.where`` select —
no host syncs, no scatter.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp
import numpy as np

# Status codes (per trajectory)
RUNNING = 0
SUCCESS = 1
MAX_STEPS = 2
STEP_UNDERFLOW = 3
NEWTON_STALL = 4      # repeated Newton failure / singular iteration matrix
EVENT_TERMINATED = 5
PARAMS_EXHAUSTED = 6  # step_args= slab rows ran out before the lane reached
#                       tf (the reference's per-step theta exhaustion error,
#                       dopri853ted.hpp:658-666, made per-lane)


@struct.dataclass
class Solution:
    """Batched solve result (a pytree; everything has leading batch axis M)."""

    t: jnp.ndarray            # [M] final time reached
    y: jnp.ndarray            # [M, D] final state
    status: jnp.ndarray       # [M] int8, see codes above
    stats: Dict[str, jnp.ndarray]   # per-trajectory int32 counters
    ts: Optional[jnp.ndarray] = None    # [T] shared output grid (t_eval mode)
    ys: Optional[jnp.ndarray] = None    # [M, T, D] dense-output samples
    event_t: Optional[jnp.ndarray] = None   # [M] first-event time (events mode)
    event_y: Optional[jnp.ndarray] = None   # [M, D] state at event
    event_idx: Optional[jnp.ndarray] = None  # [M] which event fired (-1 = none)
    dyn: Optional[Dict[str, jnp.ndarray]] = None  # per-step playback (DynTe)
    sens: Optional[jnp.ndarray] = None  # [K, M, D] internal-differentiation
    #                                     tangents (solve_radau(tangents=...))
    mesh: Optional[Dict[str, jnp.ndarray]] = None  # accepted-step mesh rings
    #                       (internal: solve_radau(_mesh_size=S) for adjoint)
    sens_ys: Optional[jnp.ndarray] = None  # [K, M, T, D] dense tangent
    #                         samples (solve_radau(tangents=..., t_eval=...))
    h_next: Optional[jnp.ndarray] = None  # [M] controller's signed step
    #     proposal at termination (warm start for segment chaining: the
    #     adjoint t_eval path threads it into the next segment's _h0)
    quad: Optional[jnp.ndarray] = None  # [M] or [M, Q] accumulated running-
    #     cost quadratures ∫ l(t, y) dt (solve_radau(quad=...); the CVODES
    #     quadrature-integration role — accumulated per accepted step at the
    #     step's own Radau order, truncated at t* on event-terminated lanes)
    sens_quad: Optional[jnp.ndarray] = None  # [K, M(, Q)] IND tangents of
    #     quad: dq_k = ∫ l_y·yd_k + l_θ·dθ_k dt (+ l(t*)·dt*_k on event-
    #     terminated lanes) — CVODES quadrature-sensitivity role
    sens_t: Optional[jnp.ndarray] = None  # [K, M] event-time tangents dt*_k
    #     (tangents= with events=; implicit-function correction — zero on
    #     lanes that never triggered)

    @property
    def success(self):
        return self.status == SUCCESS

    def interpolate(self, ts):
        """Post-hoc dense-output evaluation (scipy's ``sol.sol(t)`` role).

        Requires the solve to have stored its accepted-step mesh
        (``solve_ivp(..., method='radau'|'rodas', dense=N)`` with N ≥ the
        step count). ts: [T] shared query times or [M, T] per-lane. Returns
        [M, T, D]: each lane's interpolant (radau: collocation polynomial;
        rodas: CONTRO cubic) evaluated on its OWN
        step containing the query (θ-powers of the stored coefficients —
        solve order everywhere, not Hermite). Queries are clamped to the
        lane's integrated span; lanes whose step count overflowed the mesh
        capacity return NaN (never silently-wrong values).

        Vectorized as a one-hot select over the [M, N] mesh (no gathers —
        CLAUDE.md rule); peak memory O(M·N·T), so chunk very large query
        grids at the call site.
        """
        if self.mesh is None or not self.mesh or "q" not in self.mesh:
            raise ValueError("interpolate() needs the stored step mesh: "
                             "solve with dense=N (method='radau'|'rodas')")
        tm, hm = self.mesh["t"], self.mesh["h"]        # [M, N]
        ym, qm = self.mesh["y"], self.mesh["q"]        # [M, N, D], [M,N,s,D]
        m, n = tm.shape
        nacc = self.stats["naccept"]                   # [M]
        ts = jnp.asarray(ts, tm.dtype)
        if ts.ndim == 1:
            ts = jnp.broadcast_to(ts[None, :], (m, ts.shape[0]))
        kidx = jnp.arange(n)[None, :]                  # [1, N]
        live = kidx < nacc[:, None]                    # real steps only
        # clamp to the integrated span (signed h = reverse time works)
        t_end = tm + hm
        last_oh = (kidx == (nacc[:, None] - 1)) & live
        t_stop = jnp.sum(jnp.where(last_oh, t_end, 0.0), axis=1)   # [M]
        lo = jnp.minimum(tm[:, 0], t_stop)
        hi = jnp.maximum(tm[:, 0], t_stop)
        tq = jnp.clip(ts, lo[:, None], hi[:, None])    # [M, T]
        num = tq[:, None, :] - tm[:, :, None]                 # [M, N, T]
        theta = num / jnp.where(hm == 0.0, 1.0, hm)[:, :, None]
        # membership tests in MULTIPLICATION form, not on theta: a
        # compiled division may be a*reciprocal(b) (not correctly
        # rounded), so (tq−tm)/hm at a step boundary can miss 1.0 by an
        # ulp and the final query point selects NO step (the CLAUDE.md
        # division rule). num·hm ≥ 0 ⟺ θ ≥ 0 and
        # (num−hm)·hm < 0 ⟺ θ < 1 for either sign of hm (reverse time);
        # the endpoint test compares tq against tm+hm, the same rounding
        # that produced the t_stop clamp, so it is bit-exact.
        hmc = hm[:, :, None]
        inside = (num * hmc >= 0.0) & ((num - hmc) * hmc < 0.0) \
            & live[:, :, None]
        at_end = (tq[:, None, :] == t_end[:, :, None]) & last_oh[:, :, None]
        sel = (inside | at_end).astype(tm.dtype)       # exclusive one-hot
        s = qm.shape[2]
        thp = jnp.stack([theta ** (p + 1) for p in range(s)], axis=-1)
        # y_k + Σ_p θ^{p+1}·q_k[p], one-hot-summed over steps k
        vals = ym[:, :, None, :] + jnp.einsum(
            "mntp,mnpd->mntd", thp, qm,
            precision=jax.lax.Precision.HIGHEST)
        out = jnp.einsum("mnt,mntd->mtd", sel, vals,
                         precision=jax.lax.Precision.HIGHEST)
        overflow = nacc > n
        return jnp.where(overflow[:, None, None], jnp.nan, out)


def canon_cost(v):
    """Canonicalize a running-cost integrand output: [M] -> [M, 1],
    [M, Q] unchanged (shared by solve_radau(quad=), radau_adjoint(cost=),
    and radau_hvp so the three paths can never disagree on the contract)."""
    return v[:, None] if v.ndim == 1 else v


@jax.custom_jvp
def safe_sqrt(x):
    """sqrt with a defined (zero) tangent at x == 0.

    Solver error/correction norms hit EXACTLY zero on locally polynomial
    dynamics: an RK/collocation error estimate of order ≥ the local degree
    vanishes, and the second Newton correction of an exactly-solved linear
    stage system is 0. There d(√u) = du/(2√u) is 0/0 → NaN, and one NaN
    tangent poisons every sensitivity carried through the while_loop
    (debugged: jacfwd through any solver on ẏ = const). The step controller
    is not meaningfully differentiable at a zero norm anyway; the zero
    subgradient is the consistent choice (diffrax stop-gradients its
    controller for the same reason).
    """
    return jnp.sqrt(x)


@safe_sqrt.defjvp
def _safe_sqrt_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    root = jnp.sqrt(x)
    denom = jnp.where(root > 0, root, 1.0)
    return root, jnp.where(root > 0, dx / (2.0 * denom), jnp.zeros_like(dx))


def error_norm(err, y0, y1, rtol, atol):
    """Scaled RMS norm per trajectory: Hairer's err measure
    (reference Estrad, src/cpp/radaute_impl.hpp:1902-1986)."""
    sc = atol + rtol * jnp.maximum(jnp.abs(y0), jnp.abs(y1))
    return safe_sqrt(jnp.mean(jnp.square(err / sc), axis=-1))


def rms_norm(v, scale):
    return safe_sqrt(jnp.mean(jnp.square(v / scale), axis=-1))


def initial_step(f: Callable, t0, y0, f0, tf, order: int, rtol, atol,
                 args: Any, max_step):
    """Hairer's automatic initial step size (hinit), batched over M.

    Returns a SIGNED h (negative for reverse-time integration — the reference's
    PosNeg mechanism, src/cpp/radaute_impl.hpp:40,417, is a sign carried in h here).
    """
    direction = jnp.sign(tf - t0)
    direction = jnp.where(direction == 0, 1.0, direction)
    sc = atol + rtol * jnp.abs(y0)
    d0 = rms_norm(y0, sc)
    d1 = rms_norm(f0, sc)
    small = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = jnp.where(small, 1e-6, 0.01 * d0 / jnp.where(d1 == 0, 1.0, d1))
    h0 = jnp.minimum(h0, jnp.abs(tf - t0))
    y1 = y0 + (h0 * direction)[..., None] * f0
    f1 = f(t0 + h0 * direction, y1, args)
    d2 = rms_norm(f1 - f0, sc) / h0
    dm = jnp.maximum(d1, d2)
    h1 = jnp.where(dm <= 1e-15,
                   jnp.maximum(1e-6, h0 * 1e-3),
                   (0.01 / dm) ** (1.0 / (order + 1.0)))
    h = jnp.minimum(jnp.minimum(100.0 * h0, h1),
                    jnp.minimum(jnp.abs(tf - t0), max_step))
    return h * direction


def make_slab_selector(step_args, m: int, dtype):
    """Per-accepted-step parameter slabs (the reference's adaptive-stepper
    ``theta``/``nparams_step`` semantics, dopri853ted.hpp:302-308,
    seulexted.py:326-370): normalize a pytree whose leaves share leading
    axis S and return (n_slabs, slab_at) where ``slab_at(nacc)`` one-hot
    selects each lane's own row (no gathers in the hot loop). Leaves whose
    SECOND axis equals the batch size m are per-lane tables [S, M, ...]
    (the reference's per-lane theta layout)."""
    slabs = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype),
                                   step_args)
    leaves = jax.tree_util.tree_leaves(slabs)
    n_slabs = leaves[0].shape[0]
    if any(lf.shape[0] != n_slabs for lf in leaves):
        raise ValueError("step_args leaves must share leading axis S")
    slab_ids = jnp.arange(n_slabs)

    def slab_at(nacc):
        # clipped so exhausted lanes stay finite; they are failed separately
        oh = (jnp.clip(nacc, 0, n_slabs - 1)[:, None]
              == slab_ids[None, :]).astype(dtype)

        def sel(leaf):
            if leaf.ndim >= 2 and leaf.shape[1] == m:
                return jnp.einsum("ms,sm...->m...", oh, leaf)
            return jnp.einsum("ms,s...->m...", oh, leaf)

        return jax.tree_util.tree_map(sel, slabs)

    return n_slabs, slab_at


def zero_stats(m: int, names) -> Dict[str, jnp.ndarray]:
    return {k: jnp.zeros((m,), jnp.int32) for k in names}


def bump(stats: Dict[str, jnp.ndarray], name: str, mask) -> Dict[str, jnp.ndarray]:
    out = dict(stats)
    out[name] = stats[name] + mask.astype(jnp.int32)
    return out


def masked_update(mask, new, old):
    """tree-wide where(mask, new, old) with mask broadcast over trailing dims."""
    def sel(n, o):
        m = mask.reshape(mask.shape + (1,) * (n.ndim - mask.ndim))
        return jnp.where(m, n, o)
    return jax.tree_util.tree_map(sel, new, old)


def broadcast_batch(t0, tf, y0, dtype=None):
    """Normalize (t0, tf, y0) to batched [M]/[M]/[M,D] arrays."""
    y0 = jnp.atleast_2d(jnp.asarray(y0, dtype))
    m = y0.shape[0]
    t0 = jnp.broadcast_to(jnp.asarray(t0, y0.dtype), (m,))
    tf = jnp.broadcast_to(jnp.asarray(tf, y0.dtype), (m,))
    return t0, tf, y0


def collect_dense(out_ys, t_eval, t_old, h, accept, y_interp_fn):
    """Scatter dense-output samples for every t_eval point inside (t_old, t_old+h].

    ``y_interp_fn(theta)`` evaluates the step's continuous extension at
    theta ∈ [0, 1], for theta of shape [M, T] → [M, T, D].
    """
    t_new = t_old + h
    # direction-aware window membership
    lo = jnp.minimum(t_old, t_new)[:, None]
    hi = jnp.maximum(t_old, t_new)[:, None]
    tg = t_eval[None, :]
    inside = (tg > lo) & (tg <= hi) | ((tg >= lo) & (tg < hi) & (h < 0)[:, None]
                                       & (tg == lo))
    theta = (tg - t_old[:, None]) / h[:, None]
    theta = jnp.clip(theta, 0.0, 1.0)
    vals = y_interp_fn(theta)
    mask = inside & accept[:, None]
    return jnp.where(mask[..., None], vals, out_ys)


def mask_dense_after_event(out_ys, t_eval, fired, t_event, h):
    """Invalidate dense-output samples past a terminal event time.

    scipy truncates ``t_eval`` at the event time t*; with static shapes the
    analog is NaN for samples strictly beyond t* in the march direction.
    ``fired`` [M] flags lanes whose terminal event fired THIS accepted step
    (the step whose collect_dense pass filled samples across the whole step
    window, including the part beyond t*); later steps never run for those
    lanes, so one masking pass at fire time suffices. Samples at exactly t*
    keep their interpolated value y(t*).
    """
    fwd = h >= 0
    tg = t_eval[None, :]
    past = jnp.where(fwd[:, None], tg > t_event[:, None],
                     tg < t_event[:, None])
    kill = past & fired[:, None]
    return jnp.where(kill[..., None], jnp.nan, out_ys)


def derived_newton_tol(dtype, rtol):
    """Hairer's FNewt with an upper cap: max(10*eps/rtol, sqrt(rtol)) capped
    at 0.03. The cap matters in f32 at tight tolerances (rtol <= 1e-5), where
    10*eps/rtol exceeds 1 and an uncapped tolerance degenerates the Newton
    convergence/divergence tests; 0.03 is the loosest tolerance Hairer's
    controller is designed for, and f32 Newton reaches it (the stagnation
    floor sits near 1e-2 scaled — measured on stiff VdP, round 2)."""
    import jax.numpy as jnp
    return float(min(0.03, max(10 * float(jnp.finfo(dtype).eps) / rtol,
                               rtol ** 0.5)))


def index_weights(opts, dim, dtype):
    """Hairer's higher-index DAE weighting (reference NbrInd1-3,
    radaute.hpp:52-96): index-2/3 components get error and Newton norms
    scaled by h / h² — returns (exponent vector [D], use_index flag).
    Components must be ordered [index-1 | index-2 | index-3]."""
    import numpy as np
    ind_exp = np.zeros(dim)
    if opts.nind2 or opts.nind3:
        n1 = opts.nind1 if opts.nind1 else dim - opts.nind2 - opts.nind3
        ind_exp[n1:n1 + opts.nind2] = 1.0
        ind_exp[n1 + opts.nind2:n1 + opts.nind2 + opts.nind3] = 2.0
    return jnp.asarray(ind_exp, dtype), bool(opts.nind2 or opts.nind3)


def two_sum(a, b):
    """Error-free transform: a + b = s + err exactly (Knuth TwoSum, 6 flops).
    XLA preserves IEEE semantics (no unsafe reassociation), so this survives
    compilation on CPU and GPU."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def comp_add(hi, lo, x):
    """Double-word accumulate: (hi, lo) + x -> renormalized (hi', lo').

    The state-accumulation kernel of the compensated-f32 mode
    (Options.compensated): y_{n+1} = y_n + z and t_{n+1} = t_n + h pick up
    one ulp of rounding per step in plain f32 (~1e-7 relative), which over
    hundreds of steps dominates an rtol 1e-6 error budget; carrying the
    rounding remainder in `lo` removes the accumulation term entirely
    (error O(eps^2) per step)."""
    s, e = two_sum(hi, x)
    lo2 = lo + e
    hi2 = s + lo2
    lo3 = lo2 - (hi2 - s)
    return hi2, lo3


def quad_gl3_step(ql, t_old, h, interp, accept, terminate, t_ev, q_acc):
    """Accumulate a running-cost quadrature over one accepted step by
    3-point Gauss-Legendre on the step's dense-output interpolant (exact
    to degree 5 — above every family's interpolant order, so the
    quadrature error is dominated by the interpolant's own O(h^p)).

    ql:     canonicalized integrand (t [M], y [M, D]) -> [M, Q]
    interp: theta [M, K] -> y [M, K, D] (the step's continuous extension)
    Event-terminated lanes integrate only to θ* = (t*−t_old)/h on the
    scaled interpolant. Gated on any lane accepting (the optional-work
    convention). Shared by the rodas and seulex quad= paths; radau uses
    its own collocation-weight rule (the stages are already at the nodes).
    """
    import jax as _jax

    dtype = t_old.dtype
    s35 = 0.6 ** 0.5
    gl_xi = jnp.asarray([0.5 * (1 - s35), 0.5, 0.5 * (1 + s35)], dtype)
    gl_w = jnp.asarray([5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0], dtype)

    def do_quad(_):
        theta_q = jnp.where(terminate,
                            jnp.clip((t_ev - t_old)
                                     / jnp.where(h == 0.0, 1.0, h),
                                     0.0, 1.0), 1.0)
        nodes = theta_q[:, None] * gl_xi[None, :]              # [M, 3]
        yq = interp(nodes)                                     # [M, 3, D]
        tq = t_old[:, None] + nodes * h[:, None]
        lv = jnp.stack([ql(tq[:, i], yq[:, i]) for i in range(3)],
                       axis=1)                                 # [M, 3, Q]
        dq = (h * theta_q)[:, None] * jnp.sum(
            gl_w[None, :, None] * lv, axis=1)
        return jnp.where(accept[:, None], q_acc + dq, q_acc)

    return _jax.lax.cond(jnp.any(accept), do_quad, lambda _: q_acc, None)
