"""janus-tpu: massively-batched stiff ODE solving with forward and reverse sensitivities.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of optstat/janus-ode
(reference: /root/reference — see SURVEY.md):

- ``jet``     — batched dual-number (jet) arithmetic; the TensorDual/TensorMatDual role
                (reference: janus-tensor-dual external lib) as a JAX pytree with
                hand-written tangent rules + a generic ``lift`` via jax.linearize.
- ``ham``     — Hamiltonian calculus: dynamics [ṗ, ẋ] and Jacobians from a user scalar
                H(x, p[, u], W) via grad/jacfwd composition (replaces the ~40-function
                derivative zoo in reference src/cpp/janus_ode_common.hpp:178-2410).
- ``linalg``  — batched small-matrix LU factor/solve vectorized over the batch (the
                janus-linear role), with custom JVP dx = A⁻¹(db − dA·x)
                (reference: solve_LUdual, src/cpp/radauted_impl.hpp:1901-1936).
- ``solve``   — lockstep masked adaptive steppers (Dopri5/Dopri853, Radau IIA,
                SEULEX, BDF2, Rosenbrock) as pure functions under lax.while_loop.
- ``control`` — outer nonlinear layer: shooting, pseudo-transient continuation
                (SER-A/SER-B), homotopy, augmented Lagrangian.
- ``models``  — problem library (Van der Pol, harmonic oscillator, Dubins, LQR,
                neural-network Hamiltonians).
- ``parallel``— mesh/sharding of the batch axis (NamedSharding over the devices).
- ``ops``     — the stage-LU Pallas kernel for the GPU (Triton route).
- ``config``  — platform policy: dtype, kernel choice, tridiagonal dispatch,
                compile cache.
- ``diag``    — solver statistics and per-step playback logs (StatsTe/DynTe role).
"""

__version__ = "0.1.0"

from janus_tpu import config as config

from janus_tpu.jet import Jet
from janus_tpu.solve import solve_ivp, Solution

__all__ = ["Jet", "solve_ivp", "Solution", "config", "__version__"]
