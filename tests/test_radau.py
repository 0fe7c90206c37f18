"""Radau IIA: derived-table pinning, stiff oracles vs scipy, sensitivities.

The stiff VdP configs mirror the reference's flagship tests
(tests/cpp/ode_solver_test.cpp:620-763; examples μ up to 1e4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp as scipy_solve

from janus_tpu.solve import solve_ivp, Options, SUCCESS
from janus_tpu.solve.radau_tables import radau_tableau
from janus_tpu.models.problems import vdp_rhs, vdp_jac, harmonic_rhs


def test_tables_match_published_radau5():
    from scipy.integrate._ivp import radau as sr
    t = radau_tableau(3)
    np.testing.assert_allclose(t.c, sr.C, atol=1e-13)
    np.testing.assert_allclose(t.mu_real, sr.MU_REAL, atol=1e-12)
    np.testing.assert_allclose(t.mu_complex[0], sr.MU_COMPLEX, atol=1e-12)
    np.testing.assert_allclose(t.e, sr.E, atol=1e-10)
    np.testing.assert_allclose(t.p, sr.P, atol=1e-10)


@pytest.mark.parametrize("s", [3, 5, 7])
def test_tables_block_structure(s):
    t = radau_tableau(s)
    ainv = np.linalg.inv(t.a)
    blk = t.ti_mat @ ainv @ t.t_mat
    expect = np.zeros((s, s))
    expect[0, 0] = t.mu_real
    for k, mu in enumerate(t.mu_complex):
        i = 1 + 2 * k
        expect[i, i] = expect[i + 1, i + 1] = mu.real
        expect[i, i + 1] = -mu.imag
        expect[i + 1, i] = mu.imag
    np.testing.assert_allclose(blk, expect, atol=1e-9)
    # quadrature order conditions: Σ b c^{k-1} = 1/k up to k=s
    for k in range(1, s + 1):
        np.testing.assert_allclose(np.sum(t.b * t.c ** (k - 1)), 1.0 / k,
                                   atol=1e-12)


def scipy_vdp_radau(mu, y0, tf, rtol, atol):
    return scipy_solve(
        lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
        (0.0, tf), y0, method="Radau", rtol=rtol, atol=atol,
        jac=lambda t, y: [[0.0, 1.0],
                          [-2 * mu * y[0] * y[1] - 1, mu * (1 - y[0] ** 2)]])


def test_stiff_vdp_mu1000_vs_scipy():
    mu = 1000.0
    rtol, atol = 1e-6, 1e-9
    tf = 100.0
    ref = scipy_vdp_radau(mu, [2.0, 0.0], tf, rtol, atol)
    sol = solve_ivp(vdp_rhs, (0.0, tf), jnp.array([[2.0, 0.0]]),
                    method="radau", args=mu, rtol=rtol, atol=atol)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0], ref.y[:, -1], rtol=2e-4, atol=1e-6)
    # similar effort to scipy (within 3x steps)
    assert int(sol.stats["nsteps"][0]) < 3 * ref.t.size + 100


def test_stiff_heterogeneous_batch():
    """Batch with wildly different stiffness — per-lane adaptivity."""
    mus = jnp.array([1.0, 10.0, 100.0, 1000.0])
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (4, 1))
    sol = solve_ivp(vdp_rhs, (0.0, 20.0), y0, method="radau", args=mus,
                    rtol=1e-6, atol=1e-9)
    assert bool(jnp.all(sol.status == SUCCESS))
    for i, mu in enumerate(np.asarray(mus)):
        ref = scipy_vdp_radau(float(mu), [2.0, 0.0], 20.0, 1e-6, 1e-9)
        np.testing.assert_allclose(sol.y[i], ref.y[:, -1], rtol=2e-4,
                                   atol=2e-5)
        # per-lane effort comparable to a dedicated scipy solve (within 1.5x)
        assert int(sol.stats["nsteps"][i]) < 1.5 * ref.t.size + 30


def test_analytic_jacobian_path():
    mu = 100.0
    sol = solve_ivp(vdp_rhs, (0.0, 10.0), jnp.array([[2.0, 0.0]]),
                    method="radau", args=mu, rtol=1e-7, atol=1e-10)
    from janus_tpu.solve.radau import solve_radau
    sol2 = solve_radau(vdp_rhs, 0.0, 10.0, jnp.array([[2.0, 0.0]]),
                       args=mu, options=Options(rtol=1e-7, atol=1e-10),
                       jac=vdp_jac)
    np.testing.assert_allclose(sol.y, sol2.y, rtol=1e-6, atol=1e-8)
    assert int(sol2.status[0]) == SUCCESS


def test_dense_output_stiff():
    mu = 50.0
    t_eval = jnp.linspace(0.0, 10.0, 11)
    sol = solve_ivp(vdp_rhs, (0.0, 10.0), jnp.array([[2.0, 0.0]]),
                    method="radau", args=mu, rtol=1e-8, atol=1e-11,
                    t_eval=t_eval)
    ref = scipy_solve(
        lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
        (0.0, 10.0), [2.0, 0.0], method="Radau", rtol=1e-8, atol=1e-11,
        t_eval=np.asarray(t_eval))
    assert not np.any(np.isnan(np.asarray(sol.ys)))
    np.testing.assert_allclose(sol.ys[0], ref.y.T, rtol=1e-4, atol=1e-6)


def test_radau_reverse_time():
    """Reverse integration (PosNeg role) on a reversible system. (Reverse VdP
    over long windows is genuinely unstable — scipy Radau blows up at the same
    point — so use the oscillator.)"""
    omega = 1.3
    fwd = solve_ivp(harmonic_rhs, (0.0, 4.0), jnp.array([[1.0, 0.3]]),
                    method="radau", args=omega, rtol=1e-10, atol=1e-13)
    back = solve_ivp(harmonic_rhs, (4.0, 0.0), fwd.y, method="radau",
                     args=omega, rtol=1e-10, atol=1e-13)
    assert int(back.status[0]) == SUCCESS
    np.testing.assert_allclose(back.y, [[1.0, 0.3]], rtol=1e-6, atol=1e-7)


def test_forward_sensitivity_through_radau():
    """jvp through the stiff adaptive solve vs finite-difference re-solves
    (the reference's SensitivityTest oracle, atol 1e-3/1e-4)."""
    mu = 100.0
    tf = 1.0

    def final(y0):
        sol = solve_ivp(vdp_rhs, (0.0, tf), y0[None, :], method="radau",
                        args=mu, rtol=1e-9, atol=1e-12)
        return sol.y[0]

    y0 = jnp.array([2.0, 0.0])
    v = jnp.array([1.0, 0.0])
    _, tangent = jax.jvp(final, (y0,), (v,))
    eps = 1e-5
    fd = (final(y0 + eps * v) - final(y0 - eps * v)) / (2 * eps)
    np.testing.assert_allclose(tangent, fd, rtol=2e-3, atol=1e-4)


def test_jacobian_reuse_happens():
    """Factorization/Jacobian gating: far fewer LU/jac than steps on a mild
    problem (the deadzone keeps factors)."""
    sol = solve_ivp(vdp_rhs, (0.0, 20.0), jnp.array([[2.0, 0.0]]),
                    method="radau", args=5.0, rtol=1e-5, atol=1e-8)
    st = {k: int(v[0]) for k, v in sol.stats.items()}
    assert st["njev"] < st["nsteps"]
    assert st["naccept"] > 0 and st["nsteps"] >= st["naccept"]


def test_implicit_euler_s1():
    """s=1 (implicit Euler) converges on an exponential decay."""
    f = lambda t, y, args: -y
    sol = solve_ivp(f, (0.0, 1.0), jnp.array([[1.0]]), method="radau",
                    options=Options(rtol=1e-6, atol=1e-9, min_stages=1,
                                    max_stages=1))
    assert int(sol.status[0]) == SUCCESS
    # order 1: global error ≈ per-step tol × nsteps
    np.testing.assert_allclose(sol.y[0, 0], np.exp(-1.0), rtol=1e-3)


@pytest.mark.parametrize("s", [5, 7])
def test_high_order_radau(s):
    """Order 9/13 variants solve the stiff problem with fewer steps."""
    mu = 1000.0
    sol3 = solve_ivp(vdp_rhs, (0.0, 3.0), jnp.array([[2.0, 0.0]]),
                     method="radau", args=mu, rtol=1e-9, atol=1e-12)
    sol_hi = solve_ivp(vdp_rhs, (0.0, 3.0), jnp.array([[2.0, 0.0]]),
                       method="radau", args=mu,
                       options=Options(rtol=1e-9, atol=1e-12, min_stages=s,
                                       max_stages=s))
    assert int(sol_hi.status[0]) == SUCCESS
    np.testing.assert_allclose(sol_hi.y, sol3.y, rtol=1e-6, atol=1e-8)
    assert int(sol_hi.stats["nsteps"][0]) < int(sol3.stats["nsteps"][0])


def test_compensated_f32_long_horizon():
    """Options(compensated=True): double-word y/t accumulation must hold
    rtol~1e-6-class global accuracy in f32 over a long horizon where plain
    f32 drifts (the rtol 1e-6 in f32 use case)."""
    import numpy as np
    exact = [np.cos(200.0), -np.sin(200.0)]
    errs = {}
    for comp in (False, True):
        sol = solve_ivp(harmonic_rhs, (0.0, 200.0),
                        jnp.array([[1.0, 0.0]], jnp.float32),
                        method="radau", args=1.0, rtol=1e-6, atol=1e-9,
                        options=Options(compensated=comp, pivoting=False))
        assert int(sol.status[0]) == 1
        errs[comp] = float(np.max(np.abs(
            np.asarray(sol.y[0], np.float64) - exact)))
    assert errs[True] < 1e-5, errs
    assert errs[True] < errs[False] / 20.0, errs


def test_f32_newton_floor_no_stall():
    """f32 at rtol 1e-6: lanes with moderate Newton contraction hit the
    rounding floor (scaled dw can't drop below ~eps/rtol) with measured
    rate ~= 1 and used to be killed by the divergence test -> NEWTON_STALL
    (observed in f32 at these mu values). The floor test must count them
    converged, with accuracy still at tolerance."""
    mus32 = jnp.asarray([38.52, 77.83, 84.15, 85.22, 240.0], jnp.float32)
    m = mus32.shape[0]
    y032 = jnp.tile(jnp.array([[2.0, 0.0]], jnp.float32), (m, 1))
    sol = solve_ivp(vdp_rhs, (0.0, 1.0), y032, method="radau", args=mus32,
                    options=Options(rtol=1e-6, atol=1e-9, pivoting=False,
                                    compensated=True))
    assert bool(jnp.all(sol.status == SUCCESS)), np.asarray(sol.status)
    ref = solve_ivp(vdp_rhs, (0.0, 1.0),
                    jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1)),
                    method="radau", args=jnp.asarray(mus32, jnp.float64),
                    rtol=1e-10, atol=1e-13)
    err = np.abs(np.asarray(sol.y, np.float64) - np.asarray(ref.y))
    den = np.maximum(np.abs(np.asarray(ref.y)), 1.0)
    assert float(np.max(err / den)) < 3e-5
