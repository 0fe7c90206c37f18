"""Variable-order Radau (stages 1..7): oracle accuracy + order movement."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.integrate import solve_ivp as ss

# slow tier (re-tiered from the measured round-5 fast-tier survey:
# variable-order ladder compiles (510 s measured); fast-tier radaup signal lives in test_method_zoo_linear)
pytestmark = pytest.mark.slow

from janus_tpu.solve import solve_ivp, Options, SUCCESS
from janus_tpu.models.problems import vdp_rhs, harmonic_rhs


def test_radaup_stiff_vdp_accuracy():
    mu = 1000.0
    ref = ss(lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
             (0.0, 2.0), [2.0, 0.0], method="Radau", rtol=1e-10, atol=1e-13)
    sol = solve_ivp(vdp_rhs, (0.0, 2.0), jnp.array([[2.0, 0.0]]),
                    method="radaup", args=mu, rtol=1e-8, atol=1e-11)
    assert int(sol.status[0]) == SUCCESS
    np.testing.assert_allclose(sol.y[0], ref.y[:, -1], rtol=1e-5, atol=1e-7)


def test_radaup_tight_tol_beats_fixed_s3():
    """At tight tolerance the variable-order solver should use higher orders
    and take fewer steps than fixed s=3."""
    mu = 1000.0
    opts = dict(rtol=1e-10, atol=1e-13)
    s3 = solve_ivp(vdp_rhs, (0.0, 2.0), jnp.array([[2.0, 0.0]]),
                   method="radau", args=mu, **opts)
    vo = solve_ivp(vdp_rhs, (0.0, 2.0), jnp.array([[2.0, 0.0]]),
                   method="radaup", args=mu, **opts)
    assert int(vo.status[0]) == SUCCESS
    assert int(vo.stats["nsteps"][0]) < int(s3.stats["nsteps"][0])


def test_radaup_heterogeneous_batch():
    mus = jnp.array([1.0, 1000.0])
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (2, 1))
    sol = solve_ivp(vdp_rhs, (0.0, 5.0), y0, method="radaup", args=mus,
                    rtol=1e-8, atol=1e-11)
    assert bool(jnp.all(sol.status == SUCCESS))
    for i, mu in enumerate(np.asarray(mus)):
        ref = ss(lambda t, y: [y[1], mu * (1 - y[0] ** 2) * y[1] - y[0]],
                 (0.0, 5.0), [2.0, 0.0], method="Radau", rtol=1e-10,
                 atol=1e-13)
        np.testing.assert_allclose(sol.y[i], ref.y[:, -1], rtol=1e-4,
                                   atol=1e-6)


def test_radaup_dense_and_events():
    from janus_tpu.solve.events import Event
    omega = 1.0
    t_eval = jnp.linspace(0.0, 5.0, 11)
    sol = solve_ivp(harmonic_rhs, (0.0, 5.0), jnp.array([[1.0, 0.0]]),
                    method="radaup", args=omega, rtol=1e-9, atol=1e-12,
                    t_eval=t_eval)
    np.testing.assert_allclose(sol.ys[0, :, 0], np.cos(np.asarray(t_eval)),
                               rtol=1e-5, atol=1e-6)
    g = lambda t, y, args: y[:, 0]
    se = solve_ivp(harmonic_rhs, (0.0, 5.0), jnp.array([[1.0, 0.0]]),
                   method="radaup", args=omega, rtol=1e-9, atol=1e-12,
                   events=Event(g, terminal=True))
    np.testing.assert_allclose(se.event_t[0], np.pi / 2, rtol=1e-7)


def test_f32_caps_order_ladder():
    """f32 lanes must not be raised to s=7 (order-13 stage systems lose the
    f32 Newton); the ladder caps at s=5 and the stiff
    solve succeeds."""
    m = 16
    mus = jnp.asarray(np.logspace(0.5, 3.0, m), jnp.float32)
    y0 = jnp.tile(jnp.array([[2.0, 0.0]], jnp.float32), (m, 1))
    sol = solve_ivp(vdp_rhs, (0.0, 1.0), y0, method="radaup", args=mus,
                    options=Options(rtol=1e-5, atol=1e-8, pivoting=False))
    assert float(jnp.mean((sol.status == SUCCESS).astype(jnp.float32))) == 1.0


# ---- first-class IND tangents at per-lane variable order -------------------

def _identity_seeds(m, d):
    return jnp.stack([jnp.zeros((m, d)).at[:, j].set(1.0) for j in range(d)])


def test_radaup_ind_matches_jvp_and_fd():
    """Variable-order IND: the tangent sweep follows each lane's own order
    ladder reusing that order's LU; matches jvp-through-the-solve and FD."""
    tf = 1.0
    mus = jnp.array([30.0, 300.0, 1000.0])
    m = mus.shape[0]
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))
    opts = dict(rtol=1e-9, atol=1e-12)
    seeds = _identity_seeds(m, 2)

    sol = solve_ivp(vdp_rhs, (0.0, tf), y0, method="radaup", args=mus,
                    tangents=seeds, **opts)
    assert bool(jnp.all(sol.status == SUCCESS))
    assert sol.sens.shape == (2, m, 2)

    def final(z):
        return solve_ivp(vdp_rhs, (0.0, tf), z, method="radaup", args=mus,
                         **opts).y

    Jjvp = jnp.stack([jax.jvp(final, (y0,), (seeds[k],))[1]
                      for k in range(2)])
    np.testing.assert_allclose(np.asarray(sol.sens), np.asarray(Jjvp),
                               rtol=3e-4, atol=1e-6)

    eps = 1e-6
    for k in range(2):
        fd = (final(y0 + eps * seeds[k]) - final(y0 - eps * seeds[k])) \
            / (2 * eps)
        np.testing.assert_allclose(np.asarray(sol.sens[k]), np.asarray(fd),
                                   rtol=5e-4, atol=1e-5)


def test_radaup_ind_parameter_sensitivity():
    """args_tangents through the variable-order solver vs FD in mu."""
    tf = 1.0
    mus = jnp.array([50.0, 400.0])
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (2, 1))
    opts = dict(rtol=1e-9, atol=1e-12)

    sol = solve_ivp(vdp_rhs, (0.0, tf), y0, method="radaup", args=mus,
                    args_tangents=jnp.ones((1, 2)), **opts)
    assert bool(jnp.all(sol.status == SUCCESS))

    eps = 1e-4
    yp = solve_ivp(vdp_rhs, (0.0, tf), y0, method="radaup",
                   args=mus + eps, **opts).y
    ym = solve_ivp(vdp_rhs, (0.0, tf), y0, method="radaup",
                   args=mus - eps, **opts).y
    fd = (yp - ym) / (2 * eps)
    np.testing.assert_allclose(np.asarray(sol.sens[0]), np.asarray(fd),
                               rtol=5e-4, atol=1e-7)


def test_radaup_ind_composes_with_t_eval():
    """sens_ys off the per-order tangent collocation polynomial (padded to
    the ladder's shared power basis) must match jvp-of-the-trajectory."""
    mus = jnp.array([3.0, 30.0, 120.0])
    y0 = jnp.array([[2.0, 0.0], [1.5, 0.5], [2.2, -0.3]])
    opts = Options(rtol=1e-9, atol=1e-11)
    te = jnp.array([0.5, 1.0, 1.7])
    seeds = jnp.stack([jnp.ones_like(y0),
                       jnp.zeros_like(y0).at[:, 1].set(1.0)])
    sol = solve_ivp(vdp_rhs, (0.0, 2.0), y0, method="radaup", args=mus,
                    options=opts, t_eval=te, tangents=seeds)
    assert bool(jnp.all(sol.status == SUCCESS))
    for k in range(2):
        _, jv = jax.jvp(
            lambda z: solve_ivp(vdp_rhs, (0.0, 2.0), z, method="radaup",
                                args=mus, options=opts, t_eval=te).ys,
            (y0,), (seeds[k],))
        np.testing.assert_allclose(np.asarray(sol.sens_ys[k]),
                                   np.asarray(jv), rtol=1e-5, atol=1e-6)


def test_radaup_ind_composes_with_events():
    """Event-terminated IND: implicit-function correction of the terminal
    sensitivity + Solution.sens_t event-time tangents, FD-verified."""
    from janus_tpu.solve.events import Event
    ev = Event(lambda t, y, a: y[:, 0], terminal=True, direction=-1)
    mus = jnp.array([3.0, 8.0])
    y0 = jnp.array([[2.0, 0.0], [1.5, 0.5]])
    opts = Options(rtol=1e-9, atol=1e-11)
    seeds = jnp.stack([jnp.ones_like(y0),
                       jnp.zeros_like(y0).at[:, 1].set(1.0)])
    sol = solve_ivp(vdp_rhs, (0.0, 10.0), y0, method="radaup", args=mus,
                    options=opts, events=ev, tangents=seeds)
    assert bool(jnp.all(sol.event_idx == 0))
    eps = 1e-6
    for k in range(2):
        sp = solve_ivp(vdp_rhs, (0.0, 10.0), y0 + eps * seeds[k],
                       method="radaup", args=mus, options=opts, events=ev)
        sm = solve_ivp(vdp_rhs, (0.0, 10.0), y0 - eps * seeds[k],
                       method="radaup", args=mus, options=opts, events=ev)
        np.testing.assert_allclose(np.asarray(sol.sens[k]),
                                   np.asarray((sp.y - sm.y) / (2 * eps)),
                                   rtol=3e-4, atol=1e-4)
        np.testing.assert_allclose(
            np.asarray(sol.sens_t[k]),
            np.asarray((sp.event_t - sm.event_t) / (2 * eps)),
            rtol=3e-4, atol=1e-4)
    # parameter seed through the event correction (g_θ·dθ term)
    at = jnp.stack([jnp.ones_like(mus)])
    sol = solve_ivp(vdp_rhs, (0.0, 10.0), y0, method="radaup", args=mus,
                    options=opts, events=ev,
                    tangents=jnp.zeros((1,) + y0.shape),
                    args_tangents=at)
    sp = solve_ivp(vdp_rhs, (0.0, 10.0), y0, method="radaup",
                   args=mus + eps, options=opts, events=ev)
    sm = solve_ivp(vdp_rhs, (0.0, 10.0), y0, method="radaup",
                   args=mus - eps, options=opts, events=ev)
    np.testing.assert_allclose(np.asarray(sol.sens[0]),
                               np.asarray((sp.y - sm.y) / (2 * eps)),
                               rtol=3e-4, atol=1e-4)
    np.testing.assert_allclose(
        np.asarray(sol.sens_t[0]),
        np.asarray((sp.event_t - sm.event_t) / (2 * eps)),
        rtol=3e-4, atol=1e-4)


def test_radaup_dual_fast_path_routes_ind():
    """dual_solve_ivp(method='radaup') must take the IND fast path (no
    fallback warning) and match the transform's sensitivities."""
    import warnings
    from janus_tpu.jet import Jet, seed_identity
    from janus_tpu.jet.solve import dual_solve_ivp

    mus = jnp.array([30.0, 1000.0])
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (2, 1))
    y0j = seed_identity(y0)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        yj, tj, sol = dual_solve_ivp(vdp_rhs, (0.0, 1.0), y0j,
                                     method="radaup", args=mus,
                                     rtol=1e-9, atol=1e-12)
    assert bool(jnp.all(sol.status == SUCCESS))

    def final(z):
        return solve_ivp(vdp_rhs, (0.0, 1.0), z, method="radaup", args=mus,
                         rtol=1e-9, atol=1e-12).y

    for k in range(2):
        seed = jnp.zeros_like(y0).at[:, k].set(1.0)
        _, tan = jax.jvp(final, (y0,), (seed,))
        np.testing.assert_allclose(np.asarray(yj.d[k]), np.asarray(tan),
                                   rtol=3e-4, atol=1e-6)


@pytest.mark.slow
def test_variable_order_matrix_free_mol():
    """stage_solver='gmres'/'tridiag' on the VARIABLE-ORDER ladder (round 5):
    per-order matrix-free stage solvers from ONE probed preconditioner,
    per-lane order-dependent real-shift error estimate
    (gmres_shifted_solver with a_coef = γ0(order)/h), IND tangents riding
    the per-order gmres solvers. D=24 Fisher-KPP MOL line vs the fixed-
    stage LU oracle; reference role: decom_rc_gmres + the variable-order
    dual solver (odesolvers/linsolve.py:61-110, radauted.hpp:241-296)."""
    from tests.test_radau_gmres import _mol_rhs

    d = 24
    dx = 1.0 / (d + 1)
    xg = np.linspace(dx, 1.0 - dx, d)
    rhs = _mol_rhs(dx)
    m = 2
    y0 = jnp.tile(jnp.asarray(np.exp(-100 * (xg - 0.3) ** 2))[None], (m, 1))
    rates = jnp.array([1.0, 8.0])[:, None]
    args = (0.01, rates)

    oracle = solve_ivp(rhs, (0.0, 0.4), y0, method="radau", args=args,
                       options=Options(rtol=1e-9, atol=1e-12))

    for ss_ in ("gmres", "tridiag"):
        opts = Options(rtol=1e-6, atol=1e-9, stage_solver=ss_,
                       gmres_iters=20, min_stages=1, max_stages=5)
        s = solve_ivp(rhs, (0.0, 0.4), y0, method="radaup", args=args,
                      options=opts)
        assert bool(jnp.all(s.status == SUCCESS)), ss_
        np.testing.assert_allclose(np.asarray(s.y), np.asarray(oracle.y),
                                   rtol=0, atol=1e-7, err_msg=ss_)

    # IND tangents ride the per-order matrix-free solvers
    from janus_tpu.solve.radaup import solve_radau_vo
    opts = Options(rtol=1e-6, atol=1e-9, stage_solver="tridiag",
                   min_stages=1, max_stages=5)
    seeds = jnp.zeros((1, m, d)).at[0, :, 10].set(1.0)
    s = solve_radau_vo(rhs, jnp.zeros(m), jnp.full(m, 0.4), y0, args, opts,
                       tangents=seeds)

    def final(z):
        return solve_ivp(rhs, (0.0, 0.4), z, method="radaup", args=args,
                         options=Options(rtol=1e-9, atol=1e-12)).y

    _, tan = jax.jvp(final, (y0,), (seeds[0],))
    np.testing.assert_allclose(np.asarray(s.sens[0]), np.asarray(tan),
                               rtol=0, atol=1e-4)
