"""Batched dense linear algebra for the stiff stage solves (janus-linear role).

The reference factors ``(γ/h·M − J)`` per Radau stage — one real + (s−1)/2
complex systems, batched over M trajectories — via torch lu_factor/lu_solve
(reference src/cpp/radaute_impl.hpp:1502-1661) and propagates dual parts with one
factorization (solve_LUdual, src/cpp/radauted_impl.hpp:1901-1936, a per-sample
loop!). Here:

- ``lu_factor``/``lu_solve`` — unrolled partial-pivot LU fully vectorized over
  the batch (state dim D is small and static, so the elimination unrolls into
  fused elementwise ops — no per-sample loops, no host syncs);
- complex systems use the split real/imag 2×2-block formulation (the reference
  already splits: src/python/odesolvers/solvrad.py:22-43) — no complex
  dtype;
- ``linsolve`` carries a custom JVP dx = A⁻¹(db − dA·x) that REUSES the
  factorization, so N sensitivity directions ride through each solve at the
  cost of N back-substitutions (the solve_LUdual capability, vectorized).
"""

from janus_tpu.linalg.smalllu import (
    lu_factor,
    lu_solve,
    linsolve,
    solve_real_complex,
)

__all__ = ["lu_factor", "lu_solve", "linsolve", "solve_real_complex"]
