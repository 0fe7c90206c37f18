"""Adaptive homotopy / continuation driver.

The reference runs homotopy grids over control bounds with a process pool
(vdp_pmp_homotopy.py, dubins_pmp_homotopy.py:1-10; convex homotopy
G(x,λ)=λF(x)+(1−λ)(x−x₀) in the SSSC family). Here: one lockstep driver —
each of the M instances tracks its own λ ∈ [0,1] with an adaptive step,
corrected by damped Newton at each λ; failed corrections halve Δλ, easy ones
grow it.
"""

from __future__ import annotations

from typing import Callable

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.control.newton import fd_or_ad_jacobian
from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok


@struct.dataclass
class HomotopyResult:
    x: jnp.ndarray
    lam: jnp.ndarray          # [M] final λ reached (1.0 = success)
    converged: jnp.ndarray
    iters: jnp.ndarray


def homotopy(g: Callable, x0, dlam0: float = 0.1, tol: float = 1e-8,
             newton_iters: int = 8, max_steps: int = 200,
             dlam_min: float = 1e-6, jac_mode: str = "ad",
             dlam_fn: Callable = None) -> HomotopyResult:
    """Track g(x, λ)=0 from λ=0 to λ=1.

    g: batched ``g(x [M,N], lam [M]) -> [M,N]``; x0 must satisfy g(x0, 0)≈0.
    dlam_fn: optional continuation-step policy ``(x [M,N], lam [M],
    dlam [M]) -> dlam_next [M]`` consulted after each ACCEPTED point —
    the hook for a LEARNED step controller (the reference's SSSC-ML role,
    sssc_ml_vdp.py / sssc_dnn_vdp_model.py DeltaNet: an MLP trained on
    solver-generated data predicts the largest safe Δλ). Failed corrections
    still halve Δλ regardless of the policy (safety). Default: the reactive
    grow rule min(1.5·Δλ, 0.25).
    """
    x0 = jnp.atleast_2d(x0)
    m, n = x0.shape
    dtype = x0.dtype

    def correct(x, lam):
        """fixed-iteration damped Newton at fixed λ; returns (x, ok)."""
        def nbody(_, carry):
            x, = carry
            jmat = fd_or_ad_jacobian(lambda xx: g(xx, lam), x, jac_mode)
            lu, piv = lu_factor(jmat)
            ok = lu_ok(lu)
            step = lu_solve(lu, piv, -g(x, lam))
            return (x + jnp.where(ok[:, None], step, 0.0),)
        (x,) = jax.lax.fori_loop(0, newton_iters, nbody, (x,))
        res = jnp.linalg.norm(g(x, lam), axis=-1)
        return x, jnp.isfinite(res) & (res < tol)

    state = (x0, jnp.zeros((m,), dtype), jnp.full((m,), dlam0, dtype),
             jnp.zeros((m,), jnp.int32), jnp.ones((m,), bool))

    def cond(s):
        return jnp.any(s[4])

    def body(s):
        x, lam, dlam, it, running = s
        lam_try = jnp.minimum(lam + dlam, 1.0)
        x_cand, ok = correct(x, lam_try)
        adv = running & ok
        x_new = jnp.where(adv[:, None], x_cand, x)
        lam_new = jnp.where(adv, lam_try, lam)
        if dlam_fn is None:
            dlam_grow = jnp.minimum(dlam * 1.5, 0.25)
        else:
            dlam_grow = jnp.clip(dlam_fn(x_new, lam_new, dlam),
                                 dlam_min, 1.0)
        dlam_new = jnp.where(adv, dlam_grow, dlam * 0.5)
        dlam_new = jnp.where(running, dlam_new, dlam)
        it_new = it + running
        done = running & (lam_new >= 1.0)
        failed = running & (dlam_new < dlam_min)
        exhausted = running & (it_new >= max_steps)
        running_new = running & ~done & ~failed & ~exhausted
        return (x_new, lam_new, dlam_new, it_new, running_new)

    x, lam, dlam, it, _ = jax.lax.while_loop(cond, body, state)
    return HomotopyResult(x=x, lam=lam, converged=lam >= 1.0, iters=it)


def convex_homotopy(f: Callable, x0):
    """The SSSC convex homotopy G(x,λ) = λ·F(x) + (1−λ)·(x−x₀)
    (reference SSSC family; G(·,0) has the trivial root x₀)."""
    x0 = jnp.atleast_2d(x0)

    def g(x, lam):
        return lam[:, None] * f(x) + (1.0 - lam)[:, None] * (x - x0)

    return g
