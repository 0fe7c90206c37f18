"""Problem library: the reference's recurring test systems, batch-shaped."""

from janus_tpu.models.problems import (
    harmonic_hamiltonian,
    harmonic_rhs,
    vdp_rhs,
    vdp_jac,
    vdp_hamiltonian,
)

__all__ = [
    "harmonic_hamiltonian",
    "harmonic_rhs",
    "vdp_rhs",
    "vdp_jac",
    "vdp_hamiltonian",
]
