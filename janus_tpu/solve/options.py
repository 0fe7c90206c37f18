"""Solver options as pytree dataclasses.

One serializable options object per solver family (the reference scatters knobs
across OptionsTe/OptionsTeD structs, argparse, and the PETSc option DB —
reference src/cpp/radaute.hpp:52-96; SURVEY §5 "Config"). Float fields are pytree
leaves (retuning tolerances does not recompile); structural fields (capacities,
flags) are static aux data.
"""

from __future__ import annotations

from janus_tpu import pytree as struct
import jax.numpy as jnp


def _static(default):
    return struct.field(static=True, default=default)


@struct.dataclass
class Options:
    """Common adaptive-control options (Hairer naming where the reference uses it).

    Controller constants default to the reference's values
    (reference src/cpp/radaute.hpp:84-95, src/python/odesolvers/simplified_newton.py:62-68).
    """

    rtol: float = 1e-6
    atol: float = 1e-9
    h0: float = 0.0          # 0 → automatic initial step (Hairer hinit)
    max_step: float = jnp.inf
    safety: float = 0.9      # Safe
    min_factor: float = 0.2  # FacL: hnew >= FacL*h on reject
    max_factor: float = 8.0  # FacR: hnew <= FacR*h
    beta: float = -1.0       # PI stabilization (explicit controllers);
    #                          < 0 → the method's own default (dopri5: 0.04,
    #                          dop853: 0.0 — Hairer's choices)
    max_steps: int = _static(100000)   # per-trajectory step budget

    # implicit-solver knobs (ignored by explicit methods)
    newton_tol: float = 0.0      # 0 → derived from rtol (Hairer FNewt)
    newton_max_iter: int = _static(7)    # Nit
    jac_recompute: float = 1e-3  # Θ threshold to reuse the Jacobian (JacRecompute)
    quot1: float = 1.0           # deadzone: keep h if quot1 < hnew/h < quot2
    quot2: float = 1.2
    gustafsson: bool = _static(True)     # predictive step controller
    # variable order (Radau): min/max number of stages
    min_stages: int = _static(3)
    max_stages: int = _static(3)
    # SEULEX extrapolation-ladder depth (KMAXX; the reference's default is 13,
    # src/python/seulexted.py:13 — levels beyond a lane's k_targ+1 never run)
    seulex_kmax: int = _static(13)
    # per-step playback log capacity (0 = off; the DynTe role, SURVEY §5)
    record_steps: int = _static(0)
    # also store the accepted state per recorded step (solout buffer role)
    record_states: bool = _static(False)
    # compensated (double-word) accumulation of y and t across steps: removes
    # the one-ulp-per-step f32 drift so rtol ~1e-6 holds on long horizons in
    # f32 (radau family; no-op cost in f64)
    compensated: bool = _static(False)
    # partial pivoting in the stage LU (True = robust default; False is
    # faster and safe for the strongly diagonally-dominant iteration
    # matrices (gamma/h·M − J) of very stiff regimes)
    pivoting: bool = _static(True)
    # run the stage factor/solves through the Pallas stage-LU kernel
    # (janus_tpu.ops; LU paths of radau, rodas, bdf/NDF and seulex). GPU
    # only: config.use_stage_lu_kernel raises on any other platform and
    # when pivoting=True (the kernel is pivot-free). NOT compatible with
    # differentiating THROUGH the solve by jax.jvp/jax.grad transforms
    # (Pallas kernels carry no AD rules) — IND tangents and the continuous
    # adjoint work (they apply the factors linearly, never differentiate
    # them).
    pallas_lu: bool = _static(False)
    # keep a Householder-QR factorization alive as a per-lane fallback when
    # the stage LU breaks (zero/tiny pivot — e.g. pivoting=False on
    # structurally permuted DAE masses): instead of halving h, the failing
    # lanes solve their stage systems with QR while the rest stay on LU
    # (the reference keeps both decompositions side by side,
    # radaute_impl.hpp:1558-1573). Zero cost until a lane actually fails
    # (the QR work is cond-gated); radau LU path only.
    qr_fallback: bool = _static(False)
    # stage linear solver for the radau collocation systems: "lu" = dense
    # unrolled batched LU (D up to a few tens); "gmres" = matrix-free
    # batched GMRES(k) with a tridiagonal preconditioner (PCR or Thomas,
    # config.tridiag_method()) — the large-D method-of-lines path (the
    # reference's decom_rc_gmres role, odesolvers/linsolve.py:61-110); "tridiag" =
    # DIRECT solve of the tridiagonal part of the stage operator (no
    # Krylov work at all) — a modified-Newton iteration matrix, exact for
    # 3-point-stencil (1-D MOL) Jacobians, policed by the Newton
    # convergence monitor otherwise. gmres_iters is the static Arnoldi
    # depth k (no restart; no data-dependent control flow).
    stage_solver: str = _static("lu")
    gmres_iters: int = _static(20)
    # stage-preconditioner STRUCTURE for the matrix-free path
    # (stage_solver='gmres'/'tridiag'); all probed with colored jvp's
    # (Curtis–Powell–Reid), J never materialized:
    #   'tridiag' — 3-probe tridiagonal (1-D 3-point stencils; the default).
    #   'lines'   — line-block tridiagonal: 6 probes give the EXACT in-line
    #               tridiagonal of a line-blocked layout (2-D MOL rows of
    #               length precond_block, or species-major multi-species
    #               grids); applied with the same Thomas/PCR sweeps.
    #   'block'   — dense block-Jacobi: 2·b probes give the EXACT diagonal
    #               b×b blocks for adjacent-block couplings (cell-interleaved
    #               MOL layouts, b = dofs per cell); factored with the
    #               batched unrolled LU, complex pairs via the 2b×2b real
    #               embedding. Keep b small (≤ 16).
    # With stage_solver='tridiag' the chosen structure is solved DIRECTLY
    # (no Krylov work) — a modified-Newton iteration matrix policed by the
    # Newton convergence monitor.
    precond: str = _static("tridiag")
    precond_block: int = _static(0)
    # accepted-step mesh capacity for the continuous-adjoint backward pass
    # (solve.adjoint.radau_adjoint); gradients are NaN-poisoned if a lane
    # exceeds it. Memory: [M, adjoint_steps, s+1, D] floats.
    adjoint_steps: int = _static(256)
    # DAE index partition (Hairer NbrInd1-3, reference radaute.hpp:52-96):
    # state components must be ordered [index-1 | index-2 | index-3];
    # 0 ⇒ nind1 = D (pure ODE / index-1)
    nind1: int = _static(0)
    nind2: int = _static(0)
    nind3: int = _static(0)
