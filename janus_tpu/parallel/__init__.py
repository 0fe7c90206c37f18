"""Mesh/sharding of the trajectory batch (the reference's MPI/pool role).

The reference parallelizes across problem instances with ProcessPoolExecutor
and per-rank PETSc COMM_SELF solves + MPI gather (reference
examples/python/mpi_petsc_test.py:1-40; vdp_pmp_transient_multishoot.py:801).
Equivalent here: shard the [M] batch axis over a ``jax.sharding.Mesh``
with NamedSharding — XLA inserts the collectives (reductions like global error
norms become psum over ICI). A second optional ``model`` axis tensor-parallels
neural-Hamiltonian hidden layers.
"""

from janus_tpu.parallel.mesh import (
    make_mesh,
    shard_batch,
    replicate,
    batch_sharding,
)

__all__ = ["make_mesh", "shard_batch", "replicate", "batch_sharding"]
