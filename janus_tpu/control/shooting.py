"""Single and multiple shooting for two-point BVPs (PMP optimal control).

The reference's shooting solves segments sequentially per process
(vdp_pmp_transient_multishoot.py:240-334: scipy solve_ivp per segment;
multi_shooting_petsc.cpp:152-161: per-segment TSRK inside a SNES residual).
Batched redesign: ALL segments of ALL instances integrate in one lockstep batch —
an (M instances × S segments) solve is a single batched ``solve_ivp`` call of
batch M·S — and the outer Newton differentiates through it in forward mode.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from janus_tpu.control.newton import newton_solve, NewtonResult
from janus_tpu.solve import solve_ivp, Options


def single_shooting(residual: Callable, u0, tol: float = 1e-8,
                    max_iter: int = 30, jac_mode: str = "ad") -> NewtonResult:
    """Newton on a user-built shooting residual ``residual(u [M,N]) -> [M,N]``
    (typically: integrate the Hamiltonian system from initial guesses in u and
    return boundary/transversality defects)."""
    return newton_solve(residual, u0, tol=tol, max_iter=max_iter,
                        jac_mode=jac_mode)


def multiple_shooting_residual(f: Callable, t_nodes, y_bc: Callable,
                               method: str = "radau", args: Any = None,
                               options: Optional[Options] = None):
    """Build the batched multiple-shooting residual.

    f        : batched RHS (solver signature)
    t_nodes  : [S+1] shooting mesh over [t0, tf]
    y_bc     : ``y_bc(y_start [M,D], y_end [M,D]) -> [M,B]`` boundary residual
               (B + (S-1)·D == S·D so the system is square in the unknown
               segment starts)

    Returns ``residual(z [M, S·D]) -> [M, S·D]`` where z stacks the S segment
    start states; continuity defects come from integrating all M·S segments
    in ONE lockstep batch.
    """
    t_nodes = jnp.asarray(t_nodes)
    n_seg = t_nodes.shape[0] - 1

    def residual(z):
        m = z.shape[0]
        dim = z.shape[-1] // n_seg
        starts = z.reshape(m * n_seg, dim)                    # [M·S, D]
        t0s = jnp.tile(t_nodes[:-1], (m,))
        tfs = jnp.tile(t_nodes[1:], (m,))
        seg_args = args
        if args is not None:
            # broadcast per-instance args over segments
            seg_args = jax.tree_util.tree_map(
                lambda a: jnp.repeat(a, n_seg, axis=0)
                if hasattr(a, "ndim") and a.ndim >= 1 and a.shape[0] == m
                else a, args)
        sol = solve_ivp(f, (t0s, tfs), starts, method=method, args=seg_args,
                        options=options)
        ends = sol.y.reshape(m, n_seg, dim)
        starts_m = starts.reshape(m, n_seg, dim)
        # continuity: end of segment i == start of segment i+1
        cont = (ends[:, :-1, :] - starts_m[:, 1:, :]).reshape(m, -1)
        bc = y_bc(starts_m[:, 0, :], ends[:, -1, :])
        return jnp.concatenate([cont, bc], axis=-1)

    return residual
