"""Pseudo-transient continuation (Ψtc) with SER-A / SER-B controllers.

Kelley's Ψtc globalizes Newton on F(x)=0 by solving
(I/δₖ + J(xₖ))·s = −F(xₖ) and evolving the pseudo-timestep δ from residual
norms. The reference implements SER-A and SER-B per problem
(vdp_pmp_transient_multishoot.py:514,630; vdp_sssc.py:16-40 — the "SSSC"
engines). Controllers:

- SER-A:  δₖ₊₁ = δₖ · ‖F(xₖ)‖ / ‖F(xₖ₊₁)‖      (switched evolution relaxation)
- SER-B:  δₖ₊₁ = δ₀ / ‖F(xₖ₊₁)‖                 (inverse-residual rule)

both clipped to [δ_min, δ_max]; batched over M instances in lockstep.
"""

from __future__ import annotations

from typing import Callable

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.control.newton import fd_or_ad_jacobian
from janus_tpu.linalg.smalllu import lu_factor, lu_solve, lu_ok


@struct.dataclass
class PsitcResult:
    x: jnp.ndarray
    fnorm: jnp.ndarray
    converged: jnp.ndarray
    iters: jnp.ndarray
    delta: jnp.ndarray


def psitc(f: Callable, x0, delta0: float = 1e-2, controller: str = "ser-b",
          tol: float = 1e-8, max_iter: int = 200, delta_max: float = 1e6,
          delta_min: float = 1e-12, jac_mode: str = "ad") -> PsitcResult:
    """Solve f(x)=0 by Ψtc; f: [M,N] -> [M,N] batched."""
    if controller not in ("ser-a", "ser-b"):
        raise ValueError(f"unknown Ψtc controller {controller!r}")
    x0 = jnp.atleast_2d(x0)
    m, n = x0.shape
    dtype = x0.dtype
    eye = jnp.eye(n, dtype=dtype)

    def fnorm(x):
        return jnp.linalg.norm(f(x), axis=-1)

    fn0 = fnorm(x0)
    state = (x0, fn0, jnp.full((m,), delta0, dtype),
             jnp.zeros((m,), bool), jnp.zeros((m,), jnp.int32),
             jnp.ones((m,), bool))

    def cond(s):
        return jnp.any(s[5])

    def body(s):
        x, fn, delta, convd, it, running = s
        jmat = fd_or_ad_jacobian(f, x, jac_mode)
        amat = eye[None] / delta[:, None, None] + jmat
        lu, piv = lu_factor(amat)
        ok = lu_ok(lu)
        step = lu_solve(lu, piv, -f(x))
        x_cand = x + jnp.where(ok[:, None], step, 0.0)
        fn_cand = fnorm(x_cand)
        # reject a step that blows up: halve delta instead
        good = ok & jnp.isfinite(fn_cand) & (fn_cand < 4.0 * fn)
        x_new = jnp.where((running & good)[:, None], x_cand, x)
        fn_new = jnp.where(running & good, fn_cand, fn)
        if controller == "ser-a":
            delta_new = delta * fn / jnp.maximum(fn_new, 1e-300)
        else:
            delta_new = delta0 / jnp.maximum(fn_new, 1e-300)
        delta_new = jnp.where(good, delta_new, delta * 0.5)
        delta_new = jnp.clip(delta_new, delta_min, delta_max)
        delta_new = jnp.where(running, delta_new, delta)
        it_new = it + running
        conv_now = running & (fn_new < tol)
        stalled = running & (it_new >= max_iter)
        running_new = running & ~conv_now & ~stalled
        return (x_new, fn_new, delta_new, convd | conv_now, it_new,
                running_new)

    x, fn, delta, convd, it, _ = jax.lax.while_loop(cond, body, state)
    return PsitcResult(x=x, fnorm=fn, converged=convd, iters=it, delta=delta)
