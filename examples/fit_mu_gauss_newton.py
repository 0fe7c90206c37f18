"""Parameter estimation with internal-differentiation Jacobians.

Batched Gauss–Newton: recover each trajectory's Van der Pol stiffness mu
from noisy endpoint observations at three horizons. The residual Jacobian
d r / d mu comes from ONE `solve_radau(args_tangents=...)` sweep per
horizon per iteration (the reference's dual-parameter capability,
radauted dual params) — no finite differences, no per-parameter re-solves.

Runs a whole batch of independent fitting problems in lockstep; each lane
converges on its own mu.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax
import jax.numpy as jnp
import numpy as np

from janus_tpu.models.problems import vdp_rhs, vdp_jac
from janus_tpu.solve import Options, SUCCESS
from janus_tpu.solve.radau import solve_radau

from janus_tpu import config  # noqa: E402

config.use_default_dtype()

HORIZONS = (0.4, 0.8, 1.2)


def observe(mus, opts):
    """Endpoint y at each horizon for true parameters (data generation)."""
    m = mus.shape[0]
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1)).astype(mus.dtype)
    obs = []
    for tf in HORIZONS:
        sol = solve_radau(vdp_rhs, 0.0, tf, y0, args=mus, options=opts,
                          jac=vdp_jac)
        obs.append(sol.y)
    return jnp.stack(obs, axis=1)            # [M, H, 2]


def main():
    rng = np.random.RandomState(0)
    m = 256
    dtype = config.solver_dtype()
    mu_true = jnp.asarray(10.0 ** rng.uniform(0.8, 2.2, m), dtype)
    opts = Options(rtol=1e-7 if dtype == jnp.float64 else 1e-5,
                   atol=1e-10 if dtype == jnp.float64 else 1e-8,
                   pivoting=False)

    data = observe(mu_true, opts)
    data = data + 1e-4 * jnp.asarray(rng.randn(*data.shape), dtype)

    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1)).astype(dtype)
    ones = jnp.ones((1, m), dtype)

    @jax.jit
    def gn_step(mu_hat):
        r_rows, j_rows = [], []
        for tf in HORIZONS:
            sol = solve_radau(vdp_rhs, 0.0, tf, y0, args=mu_hat,
                              options=opts, jac=vdp_jac, args_tangents=ones)
            r_rows.append(sol.y - data[:, HORIZONS.index(tf)])
            j_rows.append(sol.sens[0])       # [M, 2] = d y(tf) / d mu
        r = jnp.concatenate(r_rows, axis=-1)          # [M, 6]
        J = jnp.concatenate(j_rows, axis=-1)          # [M, 6]
        # scalar-parameter Gauss-Newton: delta = (J.r)/(J.J), damped
        num = jnp.sum(J * r, axis=-1)
        den = jnp.sum(J * J, axis=-1) + 1e-12
        step = -num / den
        # trust region: cap the relative parameter move per iteration
        step = jnp.clip(step, -0.3 * mu_hat, 0.3 * mu_hat)
        return mu_hat + step, jnp.sqrt(jnp.mean(r * r, axis=-1))

    mu_hat = jnp.full((m,), 30.0, dtype)     # one cold start for every lane
    for it in range(30):
        mu_hat, rn = gn_step(mu_hat)
    rel = np.abs(np.asarray(mu_hat) - np.asarray(mu_true)) \
        / np.asarray(mu_true)
    print(f"batch {m}: median rel error {np.median(rel):.2e}, "
          f"90th pct {np.percentile(rel, 90):.2e}, "
          f"median resid {float(jnp.median(rn)):.2e}")
    assert np.median(rel) < 5e-3
    assert np.percentile(rel, 90) < 5e-2


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
