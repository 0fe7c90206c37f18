"""Minimum-TIME control of Van der Pol to the origin: free-final-time PMP.

The reference's flagship L3 workload solves for the final time itself with
the transversality condition H(tF) = 0 in the shooting residual — unknowns
[p10, p20, tF] (reference examples/python/vdp_pmp_transient_multishoot.py:
380-401; vdp_sssc_minT.py). Batched redesign:

  minimize  J = tF
  s.t.      ẋ1 = x2,  ẋ2 = μ(1−x1²)x2 − x1 + u,  |u| ≤ umax,
            x(0) = x0, x(tF) = 0
  PMP:      H = 1 + p1·x2 + p2·(μ(1−x1²)x2 − x1 + u),
            u* = −umax·sign(p2)  → smoothed −umax·tanh(p2/ε) with an
            ε → 0 homotopy (the Dubins example's smoothing pattern),
            residual F(p0, tF) = [x1(tF), x2(tF), H(tF)].

A whole GRID of control bounds umax converges as ONE batch (the reference
fans the (umin, umax) sweep over a ProcessPoolExecutor; here it is the batch
axis). The Newton Jacobian is assembled from FIRST-CLASS solver derivatives
instead of finite differences (reference compute_jacobian :403 is FD):

- the p0 columns ride Bock's IND — ``solve_radau(tangents=e_k)`` propagates
  the two costate seed directions through the same accepted steps;
- the tF column is the Jet-tf identity ∂y(tF)/∂tF = f(tF, y(tF)) (the
  reference's extra dual column, tests/cpp/ode_solver_test.cpp:647; here it
  costs one rhs evaluation).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax

from janus_tpu import config  # noqa: E402

config.use_default_dtype()
import jax.numpy as jnp
import numpy as np

from janus_tpu.linalg.smalllu import lu_factor, lu_solve
from janus_tpu.solve import Options
from janus_tpu.solve.radau import solve_radau

X0 = jnp.array([1.0, 0.5])
MU = 1.0


def pmp_rhs(t, y, args):
    """y = [x1, x2, p1, p2]; u = −umax·tanh(p2/ε) (smoothed bang-bang)."""
    mu, umax, eps = args
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    u = -umax * jnp.tanh(p2 / eps)
    return jnp.stack([
        x2,
        mu * (1 - x1 ** 2) * x2 - x1 + u,
        p2 * (2 * mu * x1 * x2 + 1.0),
        -p1 - p2 * mu * (1 - x1 ** 2),
    ], axis=-1)


def hamiltonian(y, args):
    """Control-smoothed H = 1 + p·f(x, u*(p)); H(tF) = 0 is the free-tF
    transversality condition of a min-time problem."""
    mu, umax, eps = args
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    u = -umax * jnp.tanh(p2 / eps)
    return 1.0 + p1 * x2 + p2 * (mu * (1 - x1 ** 2) * x2 - x1 + u)


def residual_and_jac(z, args, opts):
    """F(z) = [x1(tF), x2(tF), H(tF)] and its exact 3×3 Jacobian per lane.

    z [M, 3] = [p10, p20, tF]. Columns 0-1 from IND tangent sweeps, column 2
    from the endpoint velocity (Jet-tf)."""
    m = z.shape[0]
    p0, tf = z[:, :2], z[:, 2]
    y0 = jnp.concatenate([jnp.tile(X0[None], (m, 1)), p0], axis=-1)
    seeds = jnp.stack([
        jnp.tile(jnp.array([0.0, 0.0, 1.0, 0.0])[None], (m, 1)),
        jnp.tile(jnp.array([0.0, 0.0, 0.0, 1.0])[None], (m, 1)),
    ])                                                     # [2, M, 4]
    sol = solve_radau(pmp_rhs, 0.0, tf, y0, args=args, options=opts,
                      tangents=seeds)
    yT = sol.y                                             # [M, 4]
    f_T = pmp_rhs(tf, yT, args)                            # ∂y(tF)/∂tF
    h_T = hamiltonian(yT, args)
    mu_, umax_, eps_ = args
    um = jnp.broadcast_to(jnp.asarray(umax_, yT.dtype), (m,))
    h_grad = jax.vmap(jax.grad(
        lambda yy, ui: hamiltonian(yy, (mu_, ui, eps_))))(yT, um)

    def col(dy):                                           # [M, 4] -> [M, 3]
        return jnp.stack([dy[:, 0], dy[:, 1],
                          jnp.sum(h_grad * dy, axis=-1)], axis=-1)

    fvec = jnp.stack([yT[:, 0], yT[:, 1], h_T], axis=-1)   # [M, 3]
    jac = jnp.stack([col(sol.sens[0]), col(sol.sens[1]), col(f_T)],
                    axis=-1)                               # [M, 3, 3]
    return fvec, jac, sol


# jit ONCE at module level: an un-jitted solve_radau re-traces per call
# (closures defeat jax's cache — CLAUDE.md round-3 note); eps/umax ride as
# array leaves so the ε-homotopy never recompiles. Options is CLOSED OVER
# (solver code branches on its float fields in Python — it must be static).
OPTS = None
N_LS = 4                      # backtracking candidates per Newton step


def _raj_fn(z, args):
    return residual_and_jac(z, args, OPTS)


def _resid_fn(z, args):
    """Residual only (no tangent sweeps) — the line-search probe."""
    m = z.shape[0]
    p0, tf = z[:, :2], z[:, 2]
    y0 = jnp.concatenate([jnp.tile(X0[None], (m, 1)), p0], axis=-1)
    sol = solve_radau(pmp_rhs, 0.0, tf, y0, args=args, options=OPTS)
    return jnp.stack([sol.y[:, 0], sol.y[:, 1],
                      hamiltonian(sol.y, args)], axis=-1)


_raj = jax.jit(_raj_fn)
_resid = jax.jit(_resid_fn)


TF_MIN, TF_MAX = 0.3, 10.0
LAM_TRY = (0.1, 1.0, 10.0, 100.0)      # per-iteration damping candidates


def _clamp_tf(z):
    return z.at[:, 2].set(jnp.clip(z[:, 2], TF_MIN, TF_MAX))


def newton_free_tf(z, args, opts, iters=25, tol=1e-9):
    """Batched Levenberg-Marquardt on the free-tF shooting system.

    Pure Newton on min-time shooting blows up (the residual has a spurious
    basin at tF → 0 where x(0) − 0 stays bounded while the true branch's
    costates diverge). Per iteration each lane tries N_LS damping levels
    λ·{0.1, 1, 10, 100} — all candidates evaluated in ONE stacked batched
    residual solve of size N_LS·M (the batch axis IS the trust-region
    search) — keeps its best decrease, and adapts its own λ; tF is clamped
    to [TF_MIN, TF_MAX]."""
    global OPTS
    OPTS = opts
    m = z.shape[0]
    mu_, umax_, eps_ = args
    um = jnp.broadcast_to(jnp.asarray(umax_, z.dtype), (m,))
    args_ls = (mu_, jnp.tile(um, N_LS), eps_)
    lam = jnp.full((m,), 1e-2)
    eye3 = jnp.eye(3)
    lam_try = jnp.asarray(LAM_TRY)
    for _ in range(iters):
        fvec, jac, _ = _raj(z, args)
        fn = jnp.sqrt(jnp.sum(fvec ** 2, axis=-1))
        if bool(jnp.all(fn < tol)):
            break
        jtj = jnp.einsum("mij,mik->mjk", jac, jac)
        jtf = jnp.einsum("mij,mi->mj", jac, fvec)
        cands = []
        for k in range(N_LS):
            lk = lam * lam_try[k]
            lu, piv = lu_factor(jtj + lk[:, None, None] * eye3[None])
            cands.append(_clamp_tf(z + lu_solve(lu, piv, -jtf)))
        z_try = jnp.stack(cands).reshape(N_LS * m, 3)
        f_try = _resid(z_try, args_ls).reshape(N_LS, m, 3)
        fn_try = jnp.sqrt(jnp.sum(f_try ** 2, axis=-1))            # [L, M]
        fn_try = jnp.where(jnp.isfinite(fn_try), fn_try, jnp.inf)
        # per-lane smallest-|F| candidate (select tournament, no argmin)
        best = fn_try == jnp.min(fn_try, axis=0, keepdims=True)
        first_best = best & (jnp.cumsum(best.astype(jnp.int32), axis=0) == 1)
        z_best = jnp.sum(jnp.where(first_best[:, :, None],
                                   jnp.stack(cands), 0.0), axis=0)
        fn_best = jnp.sum(jnp.where(first_best, fn_try, 0.0), axis=0)
        lam_best = lam * jnp.sum(jnp.where(first_best, lam_try[:, None],
                                           0.0), axis=0)
        improved = fn_best < fn
        z = jnp.where(improved[:, None], z_best, z)
        lam = jnp.clip(jnp.where(improved, 0.5 * lam_best, 10.0 * lam),
                       1e-8, 1e8)
    fvec, _, sol = _raj(z, args)
    return z, jnp.sqrt(jnp.sum(fvec ** 2, axis=-1)), sol


def arrival_solve(p0, tf, args, opts, iters=20, tol=1e-10):
    """Phase 1: the FIXED-tF arrival problem x(tF) = 0 over p0 [M, 2] —
    a tame 2×2 LM warm start for the free-tF system (the reference runs
    transient/continuation stages before the [p10, p20, tF] solve for the
    same reason). Jacobian = the first two rows of the IND p-columns."""
    global OPTS
    OPTS = opts
    m = p0.shape[0]
    mu_, umax_, eps_ = args
    um = jnp.broadcast_to(jnp.asarray(umax_, p0.dtype), (m,))
    args_ls = (mu_, jnp.tile(um, N_LS), eps_)
    lam = jnp.full((m,), 1e-2)
    eye2 = jnp.eye(2)
    lam_try = jnp.asarray(LAM_TRY)
    tf_col = jnp.broadcast_to(jnp.asarray(tf, p0.dtype), (m,))[:, None]
    for _ in range(iters):
        fvec3, jac3, _ = _raj(jnp.concatenate([p0, tf_col], axis=-1), args)
        fvec = fvec3[:, :2]
        jac = jac3[:, :2, :2]
        fn = jnp.sqrt(jnp.sum(fvec ** 2, axis=-1))
        if bool(jnp.all(fn < tol)):
            break
        jtj = jnp.einsum("mij,mik->mjk", jac, jac)
        jtf = jnp.einsum("mij,mi->mj", jac, fvec)
        cands = []
        for k in range(N_LS):
            lk = lam * lam_try[k]
            lu, piv = lu_factor(jtj + lk[:, None, None] * eye2[None])
            cands.append(p0 + lu_solve(lu, piv, -jtf))
        p_try = jnp.stack(cands).reshape(N_LS * m, 2)
        f_try = _resid(jnp.concatenate(
            [p_try, jnp.tile(tf_col, (N_LS, 1))], axis=-1),
            args_ls).reshape(N_LS, m, 3)[:, :, :2]
        fn_try = jnp.sqrt(jnp.sum(f_try ** 2, axis=-1))
        fn_try = jnp.where(jnp.isfinite(fn_try), fn_try, jnp.inf)
        best = fn_try == jnp.min(fn_try, axis=0, keepdims=True)
        first_best = best & (jnp.cumsum(best.astype(jnp.int32), axis=0) == 1)
        p_best = jnp.sum(jnp.where(first_best[:, :, None],
                                   jnp.stack(cands), 0.0), axis=0)
        fn_best = jnp.sum(jnp.where(first_best, fn_try, 0.0), axis=0)
        lam_best = lam * jnp.sum(jnp.where(first_best, lam_try[:, None],
                                           0.0), axis=0)
        improved = fn_best < fn
        p0 = jnp.where(improved[:, None], p_best, p0)
        lam = jnp.clip(jnp.where(improved, 0.5 * lam_best, 10.0 * lam),
                       1e-8, 1e8)
    return p0


def solve_grid(umax_grid, eps_ladder=(1.0, 0.5, 0.2, 0.1, 0.05, 0.02),
               rtol=1e-8, tf_warm=None):
    """Converge the whole umax grid in ONE batch: phase-1 fixed-tF arrival
    warm start, then the free-tF LM through an ε → 0 smoothing homotopy,
    each rung warm-starting the next."""
    m = umax_grid.shape[0]
    opts = Options(rtol=rtol, atol=rtol * 1e-3)
    if tf_warm is None:
        # per-lane feasible arrival horizon. Two failure modes bound it:
        # tf_warm BELOW the lane's min time makes phase 1 INFEASIBLE
        # (x(tf)=0 unreachable — weak-control lanes with a fixed horizon),
        # and a barely-feasible start drops the free-tF LM into the
        # spurious tF→0 basin. So OVERestimate: ~1.25× an empirical
        # 1/umax² fit of the min time on this problem.
        tf_warm = 1.25 * (1.25 + 1.75 / jnp.asarray(umax_grid) ** 2)
    # phase 1 at the smoothest control
    args0 = (MU, umax_grid, jnp.asarray(eps_ladder[0]))
    p0 = arrival_solve(jnp.tile(jnp.array([[0.6, 0.6]]), (m, 1)), tf_warm,
                       args0, opts)
    z = jnp.concatenate([p0, jnp.broadcast_to(
        jnp.asarray(tf_warm, p0.dtype), (m,))[:, None]], axis=-1)
    fn = None
    for eps in eps_ladder:
        args = (MU, umax_grid, jnp.asarray(eps))
        z, fn, sol = newton_free_tf(z, args, opts)
    return z, fn, (MU, umax_grid, jnp.asarray(eps_ladder[-1]))


def main():
    # grid floor 0.7: below ~0.65 the min time exceeds ~6 VdP windings and
    # the single-shooting system ill-conditions (the reference multishoots
    # such horizons; segment splitting is control/shooting.py's job)
    umax = jnp.linspace(0.7, 2.0, 8)
    z, fn, args = solve_grid(umax)
    tf = np.asarray(z[:, 2])
    print("umax :", np.array2string(np.asarray(umax), precision=3))
    print("tF   :", np.array2string(tf, precision=5))
    print("|F|  :", np.array2string(np.asarray(fn), precision=2))
    assert np.all(np.diff(tf) < 0), "more control authority must be faster"

    # sanity: H is a first integral of the autonomous PMP flow — sample it
    opts = Options(rtol=1e-9, atol=1e-12)
    m = umax.shape[0]
    y0 = jnp.concatenate([jnp.tile(X0[None], (m, 1)), z[:, :2]], axis=-1)
    h_at = jax.jit(lambda tfs: hamiltonian(
        solve_radau(pmp_rhs, 0.0, tfs, y0, args=args, options=opts).y, args))
    hs = np.stack([np.asarray(h_at(z[:, 2] * frac))
                   for frac in (0.25, 0.5, 0.75, 1.0)])
    print("max |H| along trajectories:", float(np.abs(hs).max()))


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
