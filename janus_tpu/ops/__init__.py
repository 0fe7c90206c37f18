"""Pallas kernels for the GPU (Triton route) on the solvers' hot path."""

from janus_tpu.ops.smalllu_pallas import lu_factor, lu_solve, padded_shape

__all__ = ["lu_factor", "lu_solve", "padded_shape"]
