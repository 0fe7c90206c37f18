"""Augmented Lagrangian for equality-constrained minimization.

The reference uses an augmented-Lagrangian outer loop around its Ψtc engines
(vdp_pmp_transient_multishoot.py:457). Here: minimize f(x) s.t. c(x)=0 via
L_A(x; λ, μ) = f + λᵀc + (μ/2)‖c‖²; inner solve = damped Newton on ∇ₓL_A
(Hessian by forward-over-reverse AD), outer multiplier update λ ← λ + μ·c,
with μ escalation when the constraint violation decays too slowly. Batched.
"""

from __future__ import annotations

from typing import Callable

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.control.newton import newton_solve


@struct.dataclass
class AugLagResult:
    x: jnp.ndarray
    lam: jnp.ndarray          # [M, C] multipliers
    cviol: jnp.ndarray        # [M] final ‖c(x)‖∞
    converged: jnp.ndarray
    outer_iters: int


def augmented_lagrangian(obj: Callable, con: Callable, x0,
                         mu0: float = 10.0, outer_iters: int = 10,
                         inner_tol: float = 1e-9, inner_iters: int = 40,
                         ctol: float = 1e-8, mu_growth: float = 10.0):
    """obj: [M,N]->[M] batched objective; con: [M,N]->[M,C] equality
    constraints. Returns AugLagResult."""
    x0 = jnp.atleast_2d(x0)
    m, n = x0.shape
    dtype = x0.dtype
    ncon = con(x0).shape[-1]

    lam = jnp.zeros((m, ncon), dtype)
    mu = jnp.full((m,), mu0, dtype)
    x = x0
    prev_viol = jnp.full((m,), jnp.inf, dtype)

    def grad_la(x, lam, mu):
        def la_sum(xx):
            c = con(xx)
            return jnp.sum(obj(xx) + jnp.sum(lam * c, -1)
                           + 0.5 * mu * jnp.sum(c * c, -1))
        return jax.grad(la_sum)(x)

    for _ in range(outer_iters):      # outer loop is short and static
        res = newton_solve(lambda xx: grad_la(xx, lam, mu), x,
                           tol=inner_tol, max_iter=inner_iters)
        x = res.x
        c = con(x)
        viol = jnp.max(jnp.abs(c), axis=-1)
        lam = lam + mu[:, None] * c
        slow = viol > 0.25 * prev_viol
        mu = jnp.where(slow, mu * mu_growth, mu)
        prev_viol = viol

    return AugLagResult(x=x, lam=lam, cviol=prev_viol,
                        converged=prev_viol < ctol, outer_iters=outer_iters)
