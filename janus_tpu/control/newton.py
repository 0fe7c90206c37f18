"""Batched damped Newton for the outer nonlinear systems.

The reference's outer Newtons are PETSc SNES (multi_shooting_petsc.cpp:44-116)
or hand-rolled with finite-difference Jacobians
(vdp_pmp_transient_multishoot.py:403). Here: forward-mode AD columns through
the residual (which may contain whole adaptive ODE solves — they are
jvp-differentiable), batched dense LU, and Armijo backtracking, all under one
lax.while_loop over the M problem instances.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok


@struct.dataclass
class NewtonResult:
    x: jnp.ndarray            # [M, N]
    fnorm: jnp.ndarray        # [M]
    converged: jnp.ndarray    # [M]
    iters: jnp.ndarray        # [M]


def fd_or_ad_jacobian(f: Callable, x, mode: str = "ad"):
    """[M, N, N] Jacobian of a batched residual f: [M,N] -> [M,N]."""
    n = x.shape[-1]
    if mode == "ad":
        # ONE vmapped jvp over the N basis directions — N sequential jvp
        # traces make XLA compile time scale O(N) in the residual size
        basis = jnp.broadcast_to(jnp.eye(n, dtype=x.dtype)[:, None, :],
                                 (n,) + x.shape)
        cols = jax.vmap(lambda t: jax.jvp(f, (x,), (t,))[1])(basis)
        return jnp.moveaxis(cols, 0, -1)              # [M, N, N]
    eps = jnp.sqrt(jnp.finfo(x.dtype).eps)
    f0 = f(x)
    cols = []
    for j in range(n):
        h = eps * jnp.maximum(jnp.abs(x[..., j]), 1.0)
        xp = x.at[..., j].add(h)
        cols.append((f(xp) - f0) / h[..., None])
    return jnp.stack(cols, axis=-1)


def newton_solve(f: Callable, x0, tol: float = 1e-8, max_iter: int = 50,
                 jac_mode: str = "ad", max_backtracks: int = 8,
                 armijo: float = 1e-4,
                 jac: Optional[Callable] = None) -> NewtonResult:
    """Solve f(x) = 0 for a batch of instances; f: [M,N] -> [M,N].

    jac: optional user Jacobian ``jac(x) -> [M, N, N]`` replacing the AD/FD
    default — e.g. built from ``solve_radau(tangents=...)`` internal
    differentiation for shooting residuals (one primal solve instead of N
    jvp re-solves; see tests/test_radau_tangents.py).
    """
    x0 = jnp.atleast_2d(x0)
    m, n = x0.shape
    dtype = x0.dtype

    def fnorm(x):
        return jnp.linalg.norm(f(x), axis=-1)

    state = (x0, fnorm(x0), jnp.zeros((m,), bool), jnp.zeros((m,), jnp.int32),
             jnp.ones((m,), bool))

    def cond(s):
        return jnp.any(s[4])

    def body(s):
        x, fn, convd, it, running = s
        jmat = jac(x) if jac is not None else fd_or_ad_jacobian(f, x,
                                                                jac_mode)
        lu, piv = lu_factor(jmat)
        ok = lu_ok(lu)
        step = lu_solve(lu, piv, -f(x))
        step = jnp.where(ok[:, None], step,
                         -f(x) * 0.01)          # gradient-ish fallback

        # Armijo backtracking, fixed unrolled trials
        lam = jnp.ones((m,), dtype)
        best_x = x + step
        best_fn = fnorm(best_x)
        accepted = best_fn <= (1.0 - armijo) * fn
        for _ in range(max_backtracks):
            lam = jnp.where(accepted, lam, lam * 0.5)
            cand = x + lam[:, None] * step
            cfn = fnorm(cand)
            better = ~accepted & (cfn <= (1.0 - armijo * lam) * fn)
            best_x = jnp.where(better[:, None], cand, best_x)
            best_fn = jnp.where(better, cfn, best_fn)
            accepted = accepted | better
        # if nothing passed Armijo, take the last (most damped) candidate
        fallback = ~accepted
        best_x = jnp.where(fallback[:, None], x + lam[:, None] * step, best_x)
        best_fn = jnp.where(fallback, fnorm(best_x), best_fn)

        x_new = jnp.where(running[:, None], best_x, x)
        fn_new = jnp.where(running, best_fn, fn)
        it_new = it + running
        conv_now = running & (fn_new < tol)
        stalled = running & (it_new >= max_iter)
        running_new = running & ~conv_now & ~stalled
        return (x_new, fn_new, convd | conv_now, it_new, running_new)

    x, fn, convd, it, _ = jax.lax.while_loop(cond, body, state)
    return NewtonResult(x=x, fnorm=fn, converged=convd, iters=it)
