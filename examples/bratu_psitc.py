"""Pseudo-transient continuation on a reaction-diffusion steady state.

Reference analog: the PETSc Ψtc examples (pseudo_transient_vpd.cpp,
meinhart_pseudo_transient.cpp — a reaction-diffusion PDE line). Here: the
1-D Bratu problem u'' + lam·e^u = 0, u(0)=u(1)=0 — the classic Ψtc test
(turning point at lam* ≈ 3.51; plain Newton from u=0 struggles near it).

One batched run sweeps several lam values in lockstep through Ψtc (SER-A),
then the SAME steady states are re-solved matrix-free by Newton–Krylov with
the tridiagonal preconditioner (control.precond — the GMRES+ILU role) and
must agree.
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax.numpy as jnp
import numpy as np

from janus_tpu.control import newton_krylov, psitc

from janus_tpu import config  # noqa: E402

config.use_default_dtype()

N = 48
LAMS = jnp.array([0.5, 1.0, 2.0, 3.0, 3.4])


def bratu_residual(u):
    m, n = u.shape
    h = 1.0 / (n + 1)
    left = jnp.concatenate([jnp.zeros((m, 1), u.dtype), u[:, :-1]], axis=-1)
    right = jnp.concatenate([u[:, 1:], jnp.zeros((m, 1), u.dtype)], axis=-1)
    upp = (left - 2.0 * u + right) / h**2
    return upp + LAMS[:, None] * jnp.exp(u)


def main():
    m = LAMS.shape[0]
    u0 = jnp.zeros((m, N))

    # Ψtc integrates u̇ = −G toward the steady state: G must have a
    # positive-definite-ish Jacobian for the flow to be stable. The Bratu
    # residual's Jacobian is the (negative-definite) Laplacian plus a
    # positive reaction shift, so hand Ψtc G = −F (same roots).
    def G(u):
        return -bratu_residual(u)

    res = psitc(G, u0, controller="ser-a", delta0=1e-2,
                tol=1e-9, max_iter=200)
    assert bool(jnp.all(res.converged)), np.asarray(res.fnorm)
    peaks = np.asarray(jnp.max(res.x, axis=-1))
    print("Ψtc (SER-A) lower-branch steady states:")
    for lam, pk, it in zip(np.asarray(LAMS), peaks, np.asarray(res.iters)):
        print(f"  lam={lam:4.1f}  max(u)={pk:.5f}  iters={int(it)}")
    # solution amplitude grows monotonically toward the fold
    assert np.all(np.diff(peaks) > 0)

    # matrix-free Newton-Krylov + tridiagonal preconditioner, same answer
    nk = newton_krylov(bratu_residual, u0, precond="tridiag", tol=1e-9,
                       max_iter=30, gmres_restart=10, gmres_maxiter=2)
    assert bool(jnp.all(nk.converged)), np.asarray(nk.fnorm)
    agree = float(jnp.max(jnp.abs(nk.x - res.x)))
    print(f"Newton-Krylov(tridiag precond) agrees to {agree:.2e}")
    assert agree < 1e-6


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
