"""Krylov (GMRES) stage solves inside the stiff Radau integrator.

stage_solver='gmres' (solve/radau.py _gmres_stage_solver) replaces the dense
unrolled LU with matrix-free batched GMRES(k) + a tridiagonal Thomas
preconditioner — the reference's decom_rc_gmres role
(odesolvers/linsolve.py:61-110) that makes the stiff integrator usable on
method-of-lines PDE lines (examples/cpp/meinhart_pseudo_transient.cpp).
Oracle: scipy Radau at tighter tolerance on a 1-D reaction-diffusion line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

# slow tier (re-tiered from the measured round-5 fast-tier survey:
# matrix-free stage-solve compiles are the fast tier's heaviest file (851 s measured))
pytestmark = pytest.mark.slow

from janus_tpu.linalg.gmres import gmres_batched, tridiag_solve_complex
from janus_tpu.solve import Options, SUCCESS, solve_ivp
from janus_tpu.solve.radau import solve_radau


def test_gmres_batched_solves_dense_system():
    rng = np.random.default_rng(0)
    m, n = 4, 12
    a = jnp.asarray(rng.normal(size=(m, n, n)) + 5.0 * np.eye(n))
    b = jnp.asarray(rng.normal(size=(m, n)))
    mv = lambda v: jnp.einsum("mij,mj->mi", a, v)
    x, res = gmres_batched(mv, b, iters=n)       # full Krylov space: exact
    want = jnp.linalg.solve(a, b[..., None])[..., 0]
    np.testing.assert_allclose(np.asarray(x), np.asarray(want), rtol=1e-8,
                               atol=1e-10)
    assert float(jnp.max(res)) < 1e-8


def test_tridiag_solve_complex_vs_dense():
    rng = np.random.default_rng(1)
    m, n = 3, 10
    dl = rng.normal(size=(2, m, n))
    d = rng.normal(size=(2, m, n)) + np.array([6.0, 0.0])[:, None, None]
    du = rng.normal(size=(2, m, n))
    b = rng.normal(size=(2, m, n))
    xr, xi = tridiag_solve_complex(
        (jnp.asarray(dl[0]), jnp.asarray(dl[1])),
        (jnp.asarray(d[0]), jnp.asarray(d[1])),
        (jnp.asarray(du[0]), jnp.asarray(du[1])),
        (jnp.asarray(b[0]), jnp.asarray(b[1])))
    for k in range(m):
        t = np.diag(d[0, k] + 1j * d[1, k]) \
            + np.diag(dl[0, k, 1:] + 1j * dl[1, k, 1:], -1) \
            + np.diag(du[0, k, :-1] + 1j * du[1, k, :-1], 1)
        want = np.linalg.solve(t, b[0, k] + 1j * b[1, k])
        np.testing.assert_allclose(np.asarray(xr[k]), want.real, rtol=1e-9,
                                   atol=1e-11)
        np.testing.assert_allclose(np.asarray(xi[k]), want.imag, rtol=1e-9,
                                   atol=1e-11)


def _mol_rhs(dx):
    def rhs(t, y, args):
        nu, r = args
        left = jnp.pad(y[:, :-1], ((0, 0), (1, 0)))
        right = jnp.pad(y[:, 1:], ((0, 0), (0, 1)))
        lap = (left - 2 * y + right) / dx ** 2
        return nu * lap + r * y * (1.0 - y)
    return rhs


def test_gmres_mol_reaction_diffusion_matches_scipy():
    """D = 96 Fisher-KPP line (Dirichlet), two reaction rates — far beyond
    the unrolled dense LU's trace budget; must match scipy Radau."""
    from scipy.integrate import solve_ivp as ssolve

    d = 96
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    rhs = _mol_rhs(dx)
    m = 2
    y0 = jnp.tile(jnp.asarray(np.exp(-100 * (xg - 0.3) ** 2))[None], (m, 1))
    rates = jnp.array([1.0, 8.0])[:, None]
    args = (0.01, rates)
    tf = 0.4
    opts = Options(rtol=1e-6, atol=1e-9, stage_solver="gmres", gmres_iters=25)
    sol = solve_radau(rhs, 0.0, tf, y0, args=args, options=opts)
    assert bool(jnp.all(sol.status == SUCCESS))

    for i in range(m):
        r = float(rates[i, 0])

        def f1(t, y):
            lap = np.empty_like(y)
            lap[0] = (y[1] - 2 * y[0]) / dx ** 2
            lap[-1] = (y[-2] - 2 * y[-1]) / dx ** 2
            lap[1:-1] = (y[:-2] - 2 * y[1:-1] + y[2:]) / dx ** 2
            return 0.01 * lap + r * y * (1 - y)

        ref = ssolve(f1, (0, tf), np.asarray(y0[i]), method="Radau",
                     rtol=1e-8, atol=1e-11)
        assert ref.success
        np.testing.assert_allclose(np.asarray(sol.y[i]), ref.y[:, -1],
                                   rtol=1e-4, atol=1e-7)


def test_gmres_feature_exclusions():
    y0 = jnp.zeros((1, 4))
    opts = Options(stage_solver="gmres")
    f = lambda t, y, a: -y                       # noqa: E731
    with pytest.raises(ValueError):              # analytic jac is dense-only
        solve_radau(f, 0.0, 1.0, y0, options=opts,
                    jac=lambda t, y, a: jnp.zeros((1, 4, 4)))
    # (IND tangents, the n_alg DAE adjoint, and — round 5 — the
    # variable-order ladder all USED to be LU-only; every one now rides
    # the matrix-free solvers — see test_gmres_ind_tangents_match_fd,
    # test_adjoint.py::test_adjoint_gmres_index1_dae_matches_fd, and
    # test_radaup.py::test_variable_order_matrix_free_mol)


def test_gmres_adjoint_with_mass_matches_fd():
    """FEM-style tridiagonal mass + GMRES stage solves (D = 64): the
    backward pass runs matrix-free throughout — transposed stage systems,
    AND the terminal ν(T) = M⁻ᵀλ(T) / M⁻¹f velocity solves (GMRES with the
    mass's own Thomas preconditioner — exact for a tridiagonal mass).
    Primal vs scipy on M⁻¹f; gradient vs FD."""
    from scipy.integrate import solve_ivp as ssolve
    from janus_tpu.solve.adjoint import radau_adjoint

    d = 64
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    rhs = _mol_rhs(dx)
    m = 2
    y0 = jnp.tile(jnp.asarray(np.exp(-100 * (xg - 0.3) ** 2))[None], (m, 1))
    rates = jnp.array([1.0, 8.0])[:, None]
    mass = (jnp.eye(d) * 2.0 / 3.0 + jnp.eye(d, k=1) / 6.0
            + jnp.eye(d, k=-1) / 6.0)
    tf = 0.2
    opts = Options(rtol=1e-8, atol=1e-11, stage_solver="gmres",
                   gmres_iters=25, adjoint_steps=256)

    def loss(r):
        y = radau_adjoint(rhs, (0.0, tf), y0, args=(0.01, r), options=opts,
                          mass=mass)
        return jnp.sum(y ** 2), y

    (l0, yT), g = jax.value_and_grad(loss, has_aux=True)(rates)

    # primal oracle: scipy Radau on the transformed system y' = M⁻¹ f
    minv = np.linalg.inv(np.asarray(mass))
    r0 = float(rates[0, 0])

    def f1(t, y):
        lap = np.empty_like(y)
        lap[0] = (y[1] - 2 * y[0]) / dx ** 2
        lap[-1] = (y[-2] - 2 * y[-1]) / dx ** 2
        lap[1:-1] = (y[:-2] - 2 * y[1:-1] + y[2:]) / dx ** 2
        return minv @ (0.01 * lap + r0 * y * (1 - y))

    ref = ssolve(f1, (0, tf), np.asarray(y0[0]), method="Radau",
                 rtol=1e-10, atol=1e-13)
    assert ref.success
    np.testing.assert_allclose(np.asarray(yT[0]), ref.y[:, -1],
                               rtol=1e-5, atol=1e-8)

    eps = 1e-5
    for i in range(m):
        e = jnp.zeros((m, 1)).at[i, 0].set(eps)
        fd = (loss(rates + e)[0] - loss(rates - e)[0]) / (2 * eps)
        np.testing.assert_allclose(float(g[i, 0]), float(fd), rtol=1e-4,
                                   err_msg=f"lane {i}")


def test_gmres_ind_tangents_match_fd():
    """First-class IND tangents on the matrix-free path: the tangent
    collocation sweeps reuse the step's frozen GMRES stage solvers instead
    of LU back-substitutions. D = 96 Fisher-KPP line, one y0 seed (a bump
    in the initial condition) and one parameter seed (the reaction rate):
    Solution.sens must match central-FD re-solves."""
    d = 96
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    rhs = _mol_rhs(dx)
    m = 2
    y0 = jnp.tile(jnp.asarray(np.exp(-100 * (xg - 0.3) ** 2))[None], (m, 1))
    rates = jnp.array([1.0, 8.0])[:, None]
    nu = 0.01
    tf = 0.4
    opts = Options(rtol=1e-8, atol=1e-11, stage_solver="gmres",
                   gmres_iters=25)

    bump = jnp.asarray(np.exp(-50 * (xg - 0.5) ** 2))
    seed_y = jnp.tile(bump[None], (m, 1))[None]          # [1, M, D]
    seeds = jnp.concatenate([seed_y, jnp.zeros((1, m, d))], axis=0)
    args_t = (jnp.zeros((2,)), jnp.stack(
        [jnp.zeros((m, 1)), jnp.ones((m, 1))]))          # K=2: [0, drate]

    @jax.jit
    def run(z, r):
        return solve_radau(rhs, 0.0, tf, z, args=(nu, r), options=opts,
                           tangents=seeds, args_tangents=args_t)

    sol = run(y0, rates)
    assert bool(jnp.all(sol.status == SUCCESS))

    @jax.jit
    def term(z, r):
        return solve_radau(rhs, 0.0, tf, z, args=(nu, r), options=opts).y

    eps = 1e-4
    fd_y = (term(y0 + eps * seed_y[0], rates)
            - term(y0 - eps * seed_y[0], rates)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(sol.sens[0]), np.asarray(fd_y),
                               rtol=5e-4, atol=5e-7)
    fd_r = (term(y0, rates + eps) - term(y0, rates - eps)) / (2 * eps)
    np.testing.assert_allclose(np.asarray(sol.sens[1]), np.asarray(fd_r),
                               rtol=5e-4, atol=5e-7)


def test_pcr_tridiag_matches_thomas():
    """Parallel-cyclic-reduction tridiagonal solves (the GPU stage
    preconditioner; dispatched by config.tridiag_method()) must match the Thomas
    scans, real and split-real complex, across sizes incl. non-powers of 2."""
    from janus_tpu.control.precond import tridiag_solve
    from janus_tpu.linalg.gmres import (tridiag_solve_pcr,
                                        tridiag_solve_complex_pcr)

    rng = np.random.default_rng(11)
    for n in (1, 2, 3, 7, 48, 65, 96):
        m = 3
        dl, du = rng.normal(size=(2, m, n))
        d = rng.normal(size=(m, n)) + 6.0
        b = rng.normal(size=(m, n))
        x_th = tridiag_solve(*map(jnp.asarray, (dl, d, du, b)))
        x_pcr = tridiag_solve_pcr(*map(jnp.asarray, (dl, d, du, b)))
        np.testing.assert_allclose(np.asarray(x_pcr), np.asarray(x_th),
                                   rtol=1e-9, atol=1e-11, err_msg=f"n={n}")

        z = lambda: jnp.asarray(rng.normal(size=(m, n)))  # noqa: E731
        dlc, dc, duc, bc = ((z(), z()), (z() + 6.0, z()), (z(), z()),
                            (z(), z()))
        xr1, xi1 = tridiag_solve_complex(dlc, dc, duc, bc)
        xr2, xi2 = tridiag_solve_complex_pcr(dlc, dc, duc, bc)
        np.testing.assert_allclose(np.asarray(xr2), np.asarray(xr1),
                                   rtol=1e-9, atol=1e-11, err_msg=f"n={n}")
        np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi1),
                                   rtol=1e-9, atol=1e-11, err_msg=f"n={n}")


def test_tridiag_direct_stage_solver():
    """stage_solver='tridiag': DIRECT (PCR/Thomas) solve of the stage
    operator's tridiagonal part — a modified-Newton iteration matrix that
    is exact for 1-D 3-point-stencil MOL Jacobians. Solve must match
    scipy; the continuous adjoint must ride the same direct solves."""
    from scipy.integrate import solve_ivp as ssolve
    from janus_tpu.solve.adjoint import radau_adjoint

    d = 96
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    rhs = _mol_rhs(dx)
    y0 = jnp.tile(jnp.asarray(np.exp(-100 * (xg - 0.3) ** 2))[None], (2, 1))
    rates = jnp.array([1.0, 8.0])[:, None]
    opts = Options(rtol=1e-6, atol=1e-9, stage_solver="tridiag")
    sol = solve_radau(rhs, 0.0, 0.4, y0, args=(0.01, rates), options=opts)
    assert bool(jnp.all(sol.status == SUCCESS))
    for i in range(2):
        r = float(rates[i, 0])

        def f1(t, y):
            lap = np.empty_like(y)
            lap[0] = (y[1] - 2 * y[0]) / dx ** 2
            lap[-1] = (y[-2] - 2 * y[-1]) / dx ** 2
            lap[1:-1] = (y[:-2] - 2 * y[1:-1] + y[2:]) / dx ** 2
            return 0.01 * lap + r * y * (1 - y)

        ref = ssolve(f1, (0, 0.4), np.asarray(y0[i]), method="Radau",
                     rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(np.asarray(sol.y[i]), ref.y[:, -1],
                                   rtol=1e-5, atol=1e-8)

    @jax.jit
    def loss(r):
        return jnp.sum(radau_adjoint(rhs, (0.0, 0.4), y0, args=(0.01, r),
                                     options=opts) ** 2)

    g = jax.jit(jax.grad(loss))(rates)
    eps = 1e-6
    for i in range(2):
        e = jnp.zeros((2, 1)).at[i, 0].set(eps)
        fd = (loss(rates + e) - loss(rates - e)) / (2 * eps)
        np.testing.assert_allclose(float(g[i, 0]), float(fd), rtol=1e-4,
                                   err_msg=f"lane {i}")
