"""Second-order optimization through the solver: Newton-CG with radau_hvp.

Optimal-control-flavoured parameter fit: choose damping/stiffness (c, k) of
a forced oscillator so the trajectory parks at the origin with minimal
control-like effort, L(θ) = |y(T)|² + ρ·∫ y₁² dt (a Mayer + Lagrange
objective). First-order methods crawl on this loss (the two parameters are
badly scaled); Newton-CG needs only Hessian-VECTOR products, which
``radau_hvp`` delivers at two-first-order-solves cost each (CVODES
forward-over-adjoint role — the reference has no second-order machinery).

Each Newton step:
  gradient      <- jax.grad through radau_adjoint(cost=...)   (1 solve pair)
  CG on H d=-g  <- a few radau_hvp calls (matrix-free curvature)
and converges quadratically near the optimum; the script prints the
gradient-descent comparison at equal solve budget.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax
import jax.numpy as jnp
import numpy as np

from janus_tpu.control import newton_cg
from janus_tpu.solve import Options, radau_adjoint, radau_hvp

from janus_tpu import config  # noqa: E402

config.use_default_dtype()

RHO = 0.2
T = 4.0
M = 4                      # a small batch of initial conditions, fit jointly


def rhs(t, y, th):
    c, k = th["c"], th["k"]
    return jnp.stack([y[:, 1],
                      -k * y[:, 0] - c * y[:, 1] + jnp.sin(t)], axis=-1)


def cost(t, y, th):
    return y[:, 1] ** 2


def make_problem(dtype):
    rng = np.random.RandomState(3)
    y0 = jnp.asarray(rng.uniform(-1.0, 1.0, (M, 2)), dtype)
    # ~670 accepted steps on the augmented (HVP) system at rtol 1e-9:
    # size adjoint_steps above it or gradients poison to NaN by design
    opts = Options(rtol=1e-9 if dtype == jnp.float64 else 1e-5,
                   atol=1e-12 if dtype == jnp.float64 else 1e-8,
                   adjoint_steps=1024, pivoting=False)

    def loss_terms(yT, q, th):
        return jnp.sum(yT ** 2) + RHO * jnp.sum(q)

    def loss(th):
        yT, q = radau_adjoint(rhs, (0.0, T), y0, args=th, options=opts,
                              cost=cost)
        return loss_terms(yT, q, th)

    def hvp(th, v):
        (h_y0, h_th), gdotv = radau_hvp(rhs, (0.0, T), y0, th,
                                        loss=loss_terms, v_args=v,
                                        options=opts, cost=cost)
        return h_th

    return loss, hvp


def main(newton_iters=8):
    dtype = config.solver_dtype()
    loss, hvp = make_problem(dtype)
    # jit every solver-touching entry point: un-jitted calls re-TRACE the
    # whole custom-vjp solve each time (minutes instead of milliseconds)
    loss = jax.jit(loss)
    grad = jax.jit(jax.grad(loss))
    hvp = jax.jit(hvp)

    th0 = {"c": jnp.asarray(0.2, dtype), "k": jnp.asarray(4.0, dtype)}
    print("Newton-CG (control.newton_cg, radau_hvp curvature):")
    vg = jax.jit(jax.value_and_grad(loss))
    res = newton_cg(vg, hvp, th0, max_iter=newton_iters, cg_iters=4,
                    tol=1e-10 if dtype == jnp.float64 else 1e-5,
                    callback=lambda it, x, v, gn: print(
                        f"  it {it}: loss {v:.8f}  |g| {gn:.2e}  "
                        f"c {float(x['c']):.5f}  k {float(x['k']):.5f}"))
    th = res.x

    th_gd = {"c": jnp.asarray(0.2, dtype), "k": jnp.asarray(4.0, dtype)}
    # each Newton iteration above costs ~(1 + 4·2) adjoint solves; give
    # gradient descent the same solve budget
    print("gradient descent, equal solve budget:")
    lr = 0.05
    for it in range(newton_iters * 9):
        g = grad(th_gd)
        th_gd = jax.tree_util.tree_map(lambda a, b: a - lr * b, th_gd, g)
    print(f"  final loss {float(loss(th_gd)):.8f}  "
          f"c {float(th_gd['c']):.5f}  k {float(th_gd['k']):.5f}")
    print(f"Newton-CG final loss {float(loss(th)):.8f}")
    return float(loss(th)), float(loss(th_gd))


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
