"""Dubins-car PMP steering with homotopy toward bang-bang control.

The reference's second optimal-control family (dubins_pmp_homotopy.py,
seulex_dual_example_dubins.py). The min-time turn-rate control is bang-bang
(u* = −umax·sign(p3)); we smooth it as u* = −umax·tanh(p3/ε) and drive ε → 0
by continuation, re-solving the shooting problem at each ε — the same
smoothing-homotopy strategy the reference applies to its control bounds.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

from janus_tpu import config  # noqa: E402

config.use_default_dtype()

import jax.numpy as jnp
import numpy as np

from janus_tpu.control import single_shooting
from janus_tpu.models.problems import dubins_pmp_rhs
from janus_tpu.solve import solve_ivp, Options

TF = 2.0
TARGET = jnp.array([1.2, 0.8])


def residual(p0, eps):
    m = p0.shape[0]
    args = {"v": 1.0, "umax": 2.0, "eps": eps}
    y0 = jnp.concatenate([jnp.zeros((m, 3)), p0], axis=-1)
    sol = solve_ivp(dubins_pmp_rhs, (0.0, TF), y0, method="radau", args=args,
                    options=Options(rtol=1e-9, atol=1e-12))
    return jnp.concatenate([sol.y[:, :2] - TARGET[None], sol.y[:, 5:6]],
                           axis=-1)


def main():
    p0 = jnp.array([[0.1, 0.1, 0.1]])
    for eps in (0.2, 0.1, 0.05, 0.02):
        res = single_shooting(lambda p: residual(p, eps), p0, tol=1e-8)
        p0 = res.x
        print(f"eps={eps:5.2f} converged={bool(res.converged[0])} "
              f"|res|={float(res.fnorm[0]):.2e} p0={np.asarray(p0[0])}")

    # inspect the (nearly bang-bang) control signal
    args = {"v": 1.0, "umax": 2.0, "eps": 0.02}
    y0 = jnp.concatenate([jnp.zeros((1, 3)), p0], axis=-1)
    t_eval = jnp.linspace(0.0, TF, 21)
    sol = solve_ivp(dubins_pmp_rhs, (0.0, TF), y0, method="radau", args=args,
                    options=Options(rtol=1e-9, atol=1e-12), t_eval=t_eval)
    u = -2.0 * np.tanh(np.asarray(sol.ys[0, :, 5]) / 0.02)
    print("u(t):", np.array2string(u, precision=2))
    print("final position:", np.asarray(sol.ys[0, -1, :2]), "target:",
          np.asarray(TARGET))


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
