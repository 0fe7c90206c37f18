"""Mesh-sharded parameter sweep (the reference's ProcessPoolExecutor + MPI
gather role, SURVEY §2.5).

The reference fans a homotopy grid over a process pool
(vdp_pmp_transient_multishoot.py:801) and gathers per-rank PETSc solves over
MPI (mpi_petsc_test.py). Here the sweep IS the batch axis, sharded over a
device mesh with NamedSharding — XLA partitions the one lockstep
while_loop across devices, no per-rank code. Runs on any device count: the
GPUs of one host or the virtual CPU mesh (set
XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax
import jax.numpy as jnp
import numpy as np

from janus_tpu.models.problems import vdp_rhs, vdp_jac
from janus_tpu.parallel import make_mesh, shard_batch
from janus_tpu.solve import Options, SUCCESS
from janus_tpu.solve.radau import solve_radau

from janus_tpu import config  # noqa: E402

config.use_default_dtype()


def main():
    mesh = make_mesh()                 # all visible devices on axis "data"
    n_dev = mesh.devices.size
    m = 8192 * max(n_dev, 1)
    print(f"devices: {n_dev}  batch: {m}")

    mus = jnp.asarray(10.0 ** np.linspace(0.5, 3.0, m))
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))
    y0, mus = shard_batch((y0, mus), mesh)

    opts = Options(rtol=1e-6, atol=1e-9, pivoting=False)

    @jax.jit
    def sweep(y0, mus):
        sol = solve_radau(vdp_rhs, 0.0, 1.0, y0, args=mus, jac=vdp_jac,
                          options=opts)
        # a global reduction (the reference's MPI gather role): XLA emits
        # the cross-chip psum for the sharded mean itself
        return sol.y, jnp.mean(sol.stats["nsteps"]), jnp.mean(
            (sol.status == SUCCESS).astype(jnp.float32))

    yT, mean_steps, ok = sweep(y0, mus)
    print(f"success fraction: {float(ok):.4f}")
    print(f"mean steps/lane:  {float(mean_steps):.1f}")
    print(f"output sharding:  {yT.sharding}")
    assert float(ok) == 1.0


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
