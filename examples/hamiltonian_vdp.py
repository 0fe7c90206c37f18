"""Hamiltonian-first API: supply scalar H, get dynamics/Jacobians/sensitivities.

Mirrors the reference's radauted_hamiltonian_example.cpp (batched dual VdP):
the user writes H(x, p, args); dynamics [ṗ, ẋ] and the Jacobian come from AD,
and dual-number sensitivities ride through the adaptive solve.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax.numpy as jnp
import numpy as np

from janus_tpu import ham
from janus_tpu.jet.solve import solve_with_sensitivities
from janus_tpu.models.problems import vdp_hamiltonian
from janus_tpu.solve import solve_ivp, Options

from janus_tpu import config  # noqa: E402

config.use_default_dtype()
RTOL, ATOL, CHECK_RTOL = 1e-8, 1e-11, 1e-6


def main():
    mu = 100.0
    m = 8
    f = ham.hamiltonian_dynamics(vdp_hamiltonian)      # y = [p, x]
    x0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))
    p0 = jnp.zeros((m, 2)).at[:, 0].set(jnp.linspace(0.1, 1.0, m))
    y0 = jnp.concatenate([p0, x0], axis=-1)

    sol = solve_ivp(f, (0.0, 1.0), y0, method="radau", args={"mu": mu},
                    rtol=RTOL, atol=ATOL)
    print("status:", np.asarray(sol.status))
    print("x(T) lane0:", np.asarray(sol.y[0, 2:]))

    # identity-seeded sensitivities ∂y(T)/∂y0 plus the final-time column
    yj, sol2 = solve_with_sensitivities(f, (0.0, 1.0), y0,
                                        args={"mu": mu},
                                        options=Options(rtol=RTOL,
                                                        atol=ATOL),
                                        wrt_tf=True)
    print("sensitivity tensor d shape (N, M, D):", yj.d.shape)
    print("d x1(T)/d x1(0) lane0:", float(yj.d[2, 0, 2]))
    print("d y(T)/dT == f(T,y):",
          np.allclose(yj.d[-1], f(1.0, yj.r, {"mu": mu}),
                      rtol=CHECK_RTOL, atol=1e-5))


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
