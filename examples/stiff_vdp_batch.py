"""Massively batched stiff Van der Pol with forward sensitivities.

The headline workload (BASELINE config: 65k trajectories, μ=1e3).

  python examples/stiff_vdp_batch.py [batch]
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import time

import jax
import jax.numpy as jnp
import numpy as np

from janus_tpu import config
from janus_tpu.solve import Options
from janus_tpu.solve.radau import solve_radau
from janus_tpu.models.problems import vdp_rhs, vdp_jac


def main(batch=65536):
    dtype = config.use_default_dtype()
    rtol, atol = (1e-4, 1e-7) if dtype == jnp.float32 else (1e-8, 1e-11)
    y0 = jnp.tile(jnp.array([[2.0, 0.0]], dtype), (batch, 1))
    # heterogeneous stiffness across the batch
    mus = jnp.logspace(1, 3, batch, dtype=dtype)
    opts = Options(rtol=rtol, atol=atol, pivoting=False)

    @jax.jit
    def run(y0, mus):
        sol = solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, options=opts,
                          jac=vdp_jac)
        return sol.y, sol.status, sol.stats["nsteps"]

    out = run(y0, mus)
    np.asarray(out[0])                      # warm-up + compile
    t0 = time.perf_counter()
    out = run(y0 + 1e-6, mus)
    y = np.asarray(out[0])
    dt = time.perf_counter() - t0
    ok = float(jnp.mean((out[1] == 1).astype(jnp.float32)))
    print(f"batch {batch}: {dt:.3f}s  {batch/dt:,.0f} traj/s  "
          f"success {100*ok:.1f}%  steps[min..max] "
          f"{int(out[2].min())}..{int(out[2].max())}")
    print("y[0] =", y[0], " y[-1] =", y[-1])


if __name__ == "__main__":
    config.enable_compile_cache()
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 65536)
