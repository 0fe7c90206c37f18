"""Energy-optimal control of Van der Pol to the origin via PMP shooting.

The reference's L3 flagship family (vdp_pmp_transient_multishoot.py) solved
with the batched stack: smooth PMP Hamiltonian, costate dynamics by AD,
batched single/multiple shooting with forward-AD Newton, and homotopy in the
stiffness μ (solve the easy linear problem first, continue to the target μ).

  minimize  J = ∫ u²/2 dt
  s.t.      ẋ1 = x2,  ẋ2 = μ(1−x1²)x2 − x1 + u,  x(0)=x0, x(T)=0
  PMP:      u* = −p2;  ṗ1 = p2(2μx1x2+1);  ṗ2 = −p1 − p2μ(1−x1²)
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from janus_tpu import config  # noqa: E402

config.use_default_dtype()
import jax.numpy as jnp
import numpy as np

from janus_tpu.control import single_shooting, multiple_shooting_residual
from janus_tpu.control.homotopy import homotopy
from janus_tpu.solve import solve_ivp, Options

N_SEG = 6

X0 = jnp.array([1.0, 0.5])
TF = 3.0


def pmp_rhs(t, y, mu):
    """y = [x1, x2, p1, p2] with u* = −p2 substituted."""
    x1, x2, p1, p2 = y[..., 0], y[..., 1], y[..., 2], y[..., 3]
    mu = jnp.broadcast_to(jnp.asarray(mu, y.dtype), x1.shape)
    u = -p2
    return jnp.stack([
        x2,
        mu * (1 - x1 ** 2) * x2 - x1 + u,
        p2 * (2 * mu * x1 * x2 + 1.0),
        -p1 - p2 * mu * (1 - x1 ** 2),
    ], axis=-1)


def shooting_residual(p0, mu):
    """x(T) must hit the origin; unknowns are the initial costates [M,2]."""
    m = p0.shape[0]
    y0 = jnp.concatenate([jnp.tile(X0[None], (m, 1)), p0], axis=-1)
    sol = solve_ivp(pmp_rhs, (0.0, TF), y0, method="radau", args=mu,
                    options=Options(rtol=1e-8, atol=1e-11))
    return sol.y[:, :2]


def solve_direct(mu, p0_guess=None):
    p0 = jnp.zeros((1, 2)) if p0_guess is None else p0_guess
    return single_shooting(lambda p: shooting_residual(p, mu), p0, tol=1e-9)


def multishoot_residual(mu):
    """Single shooting conditions blow up like e^{μT}; MULTIPLE shooting
    (the reference's multishoot engine) keeps each segment short. All
    segments integrate as ONE lockstep batch."""
    t_nodes = jnp.linspace(0.0, TF, N_SEG + 1)

    def bc(y_start, y_end):
        return jnp.concatenate([y_start[:, :2] - X0[None], y_end[:, :2]],
                               axis=-1)

    return multiple_shooting_residual(
        pmp_rhs, t_nodes, bc, method="radau", args=mu,
        options=Options(rtol=1e-8, atol=1e-11))


def solve_by_homotopy(mu_target):
    """Continuation in μ from the trivially solvable linear problem, on the
    multiple-shooting unknowns z = stacked segment starts [1, S·4]."""
    res0 = solve_direct(0.0)
    assert bool(res0.converged[0])
    # build the initial multishoot iterate from the μ=0 single-shoot solution
    y0 = jnp.concatenate([X0[None], res0.x], axis=-1)
    t_nodes = jnp.linspace(0.0, TF, N_SEG + 1)
    sol = solve_ivp(pmp_rhs, (0.0, TF), y0, method="radau", args=0.0,
                    options=Options(rtol=1e-10, atol=1e-13),
                    t_eval=t_nodes[:-1])
    z0 = sol.ys.reshape(1, -1)

    def g(z, lam):
        return multishoot_residual(lam * mu_target)(z)

    return homotopy(g, z0, dlam0=0.25, tol=1e-7, newton_iters=6)


def main():
    for mu in (0.0, 1.0):
        res = solve_direct(mu)
        print(f"mu={mu}: converged={bool(res.converged[0])} "
              f"p0={np.asarray(res.x[0])} |x(T)|={float(res.fnorm[0]):.2e}")

    mu_t = 10.0
    hres = solve_by_homotopy(mu_t)
    print(f"homotopy to mu={mu_t}: lambda={float(hres.lam[0]):.3f}")
    final = multishoot_residual(mu_t)(hres.x)
    print(f"multishoot residual at target: "
          f"{float(jnp.linalg.norm(final)):.2e}")

    # optimal control signal u(t) = −p2(t) on a grid
    y0 = hres.x[:, :4]
    t_eval = jnp.linspace(0.0, TF, 16)
    sol = solve_ivp(pmp_rhs, (0.0, TF), y0, method="radau", args=mu_t,
                    options=Options(rtol=1e-8, atol=1e-11), t_eval=t_eval)
    u = -np.asarray(sol.ys[0, :, 3])
    cost = np.trapezoid(0.5 * u ** 2, np.asarray(t_eval))
    print("u(t):", np.array2string(u, precision=3))
    print(f"J = {cost:.4f}")


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
