"""Anderson-accelerated fixed-point / nonlinear solver (the NGMRES role).

The reference exercises PETSc's SNES NGMRES (examples/cpp/petsc_ngmres.cpp).
Anderson mixing is the standard derivative-free accelerator in that family:
it solves F(x)=0 (as the fixed point of x → x + βF(x)) using a window of the
last K residuals, with the small K×K least-squares done per batch lane.
"""

from __future__ import annotations

from typing import Callable

from janus_tpu import pytree as struct
import jax
import jax.numpy as jnp

from janus_tpu.linalg.smalllu import linsolve


@struct.dataclass
class AndersonResult:
    x: jnp.ndarray
    fnorm: jnp.ndarray
    converged: jnp.ndarray
    iters: jnp.ndarray


def anderson_solve(f: Callable, x0, window: int = 5, beta: float = 1.0,
                   tol: float = 1e-8, max_iter: int = 200,
                   reg: float = 1e-10) -> AndersonResult:
    """Solve f(x)=0 with Anderson acceleration; f batched [M,N] -> [M,N]."""
    x0 = jnp.atleast_2d(x0)
    m, n = x0.shape
    dtype = x0.dtype
    k_win = window

    # histories of iterates and residuals
    xh = jnp.zeros((m, k_win, n), dtype)
    fh = jnp.zeros((m, k_win, n), dtype)

    def fnorm(fx):
        return jnp.linalg.norm(fx, axis=-1)

    f0 = f(x0)
    state = (x0, f0, xh.at[:, 0].set(x0), fh.at[:, 0].set(f0),
             jnp.ones((m,), jnp.int32), jnp.zeros((m,), bool),
             jnp.zeros((m,), jnp.int32), jnp.ones((m,), bool))

    def cond(s):
        return jnp.any(s[7])

    def body(s):
        x, fx, xh, fh, nh, convd, it, running = s
        kcur = jnp.minimum(nh, k_win)
        # least squares: minimize ||Σ α_i f_i|| s.t. Σ α = 1 via the normal
        # equations on the Gram matrix (small K×K per lane)
        gram = jnp.einsum("mkn,mln->mkl", fh, fh)
        valid = (jnp.arange(k_win)[None, :] < kcur[:, None])
        vmask = valid[:, :, None] & valid[:, None, :]
        scale = jnp.maximum(jnp.max(jnp.abs(gram), axis=(-2, -1)), 1e-300)
        gram = jnp.where(vmask, gram,
                         (scale * 1e20)[:, None, None] * jnp.eye(k_win)[None])
        # regularize RELATIVE to the Gram scale (an absolute shift swamps the
        # tiny residual Gram near convergence and kills the acceleration)
        gram = gram + (reg * scale)[:, None, None] * jnp.eye(k_win)[None]
        ones = valid.astype(dtype)
        alpha = linsolve(gram, ones)
        alpha = alpha / jnp.sum(alpha, axis=-1, keepdims=True)
        alpha = jnp.where(valid, alpha, 0.0)

        x_new = jnp.einsum("mk,mkn->mn", alpha, xh + beta * fh)
        f_new = f(x_new)
        ok = jnp.all(jnp.isfinite(f_new), axis=-1)
        # fall back to damped Picard when the LS step misbehaves
        x_pic = x + beta * 0.5 * fx
        x_new = jnp.where(ok[:, None], x_new, x_pic)
        f_new = jnp.where(ok[:, None], f_new, f(x_pic))

        slot = nh % k_win
        rowsel = jnp.arange(k_win)[None, :] == slot[:, None]
        xh_new = jnp.where(rowsel[..., None], x_new[:, None, :], xh)
        fh_new = jnp.where(rowsel[..., None], f_new[:, None, :], fh)

        upd = running
        x2 = jnp.where(upd[:, None], x_new, x)
        fx2 = jnp.where(upd[:, None], f_new, fx)
        xh2 = jnp.where(upd[:, None, None], xh_new, xh)
        fh2 = jnp.where(upd[:, None, None], fh_new, fh)
        nh2 = nh + upd
        it2 = it + upd
        fn = fnorm(fx2)
        conv_now = running & (fn < tol)
        stalled = running & (it2 >= max_iter)
        return (x2, fx2, xh2, fh2, nh2, convd | conv_now, it2,
                running & ~conv_now & ~stalled)

    x, fx, *_, convd, it, _ = jax.lax.while_loop(cond, body, state)
    return AndersonResult(x=x, fnorm=fnorm(fx), converged=convd, iters=it)
