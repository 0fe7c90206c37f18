"""Multi-host initialization (the reference's MPI role, SURVEY §2.5).

The reference's distribution is mpi4py/PETSc per-rank solves + gather
(examples/python/mpi_petsc_test.py). Here: ``jax.distributed`` across
hosts; the batch mesh then spans every device of every process and XLA's
collectives (NCCL on GPUs) carry the any() gates. On a single host this is
a no-op.
"""

from __future__ import annotations

import logging

import jax

log = logging.getLogger("janus_tpu.distributed")


def initialize(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize multi-host JAX if configured (arguments or cluster env).

    Explicit arguments (or pod env vars) describe a genuine multi-process
    job: failures there are re-raised loudly — a misconfigured pod must not
    silently run single-host. With no arguments and no cluster environment,
    jax.distributed has nothing to auto-detect and this is a logged no-op.
    Calling twice is tolerated (idempotent).
    """
    explicit = coordinator_address is not None or num_processes is not None \
        or process_id is not None
    try:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)
        log.info("jax.distributed initialized: process %d / %d",
                 jax.process_index(), jax.process_count())
    except RuntimeError as e:
        # jax raises RuntimeError both for "already initialized" (benign)
        # and for coordination-service failures (fatal when explicit).
        if "already initialized" in str(e).lower():
            log.info("jax.distributed already initialized; ignoring")
            return
        if explicit:
            raise
        log.info("single-process run (no cluster env detected): %s", e)
    except ValueError:
        if explicit:
            raise
        log.info("jax.distributed auto-detection found no cluster; "
                 "running single-process")


def global_batch_mesh(axis: str = "data"):
    """1-D mesh over every addressable device in the job."""
    from janus_tpu.parallel.mesh import make_mesh
    return make_mesh(axes=(axis,))
