"""Options(qr_fallback=True): per-lane Householder-QR rescue of broken LU.

The reference keeps LU and QR factorizations alive side by side
(src/cpp/radaute_impl.hpp:1558-1573). Here the fallback is per-lane and
cond-gated: lanes whose stage LU breaks (zero/tiny pivot) solve via QR
while the rest stay on LU. The canonical trigger: pivot-free LU on a
permuted mass matrix whose iteration matrix γ/h·M − J has a STRUCTURAL
zero leading pivot at every h — h-halving can never fix it.
"""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest

from janus_tpu import config
from janus_tpu.solve import Options, SUCCESS
from janus_tpu.solve.radau import solve_radau

# M y' = f with M = [[0,1],[1,0]]: row0 ⇒ y1' = -y1, row1 ⇒ y0' = y1 - y0.
# A = γ/h·M − J = [[0, γ/h+1], [γ/h+1, -1]] — A[0,0] ≡ 0.
MASS = jnp.array([[0.0, 1.0], [1.0, 0.0]])


def rhs(t, y, args):
    return jnp.stack([-y[:, 1], y[:, 1] - y[:, 0]], axis=-1)


def exact(t, y0):
    """y1(t) = b e^{-t}; y0' = y1 - y0 ⇒ y0(t) = (a + b t) e^{-t}."""
    a, b = y0
    return np.array([(a + b * t) * np.exp(-t), b * np.exp(-t)])


Y0 = jnp.array([[1.0, 0.5], [0.3, -0.7]])


def test_pivot_free_lu_fails_structurally():
    sol = solve_radau(rhs, 0.0, 2.0, Y0, mass=MASS,
                      options=Options(rtol=1e-9, atol=1e-12, pivoting=False))
    assert not bool(jnp.any(sol.status == SUCCESS))


def test_qr_fallback_rescues_and_matches_exact():
    sol = solve_radau(rhs, 0.0, 2.0, Y0, mass=MASS,
                      options=Options(rtol=1e-9, atol=1e-12, pivoting=False,
                                      qr_fallback=True))
    assert bool(jnp.all(sol.status == SUCCESS))
    for i in range(2):
        np.testing.assert_allclose(np.asarray(sol.y[i]),
                                   exact(2.0, np.asarray(Y0[i])),
                                   rtol=1e-8, atol=1e-11)


def test_qr_fallback_mixed_batch_matches_lu_lanes():
    """A healthy lane (ordinary mass) must give bit-compatible results with
    and without the fallback armed (its LU never breaks, so it never sees
    the QR path); the broken-pivot lane rides QR in the same batch."""
    # lane 0: identity mass (healthy LU); lane 1: permuted mass (broken)
    m1 = jnp.eye(2)
    mass_b = jnp.stack([m1, MASS])

    def rhs_b(t, y, args):
        # lane 0: plain damped system y' = [-y0, -2 y1]
        f_plain = jnp.stack([-y[:, 0], -2.0 * y[:, 1]], axis=-1)
        f_perm = jnp.stack([-y[:, 1], y[:, 1] - y[:, 0]], axis=-1)
        lane = jnp.arange(y.shape[0])[:, None]
        return jnp.where(lane == 0, f_plain, f_perm)

    opts = Options(rtol=1e-9, atol=1e-12, pivoting=False, qr_fallback=True)
    sol = solve_radau(rhs_b, 0.0, 2.0, Y0, mass=mass_b, options=opts)
    assert bool(jnp.all(sol.status == SUCCESS))
    np.testing.assert_allclose(
        np.asarray(sol.y[0]),
        np.asarray(Y0[0]) * np.exp([-2.0, -4.0]), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(sol.y[1]),
                               exact(2.0, np.asarray(Y0[1])), rtol=1e-8,
                               atol=1e-11)


def test_qr_fallback_with_ind_tangents():
    """The hybrid solver closures carry the IND tangent sweeps too."""
    seeds = jnp.zeros((1, 2, 2)).at[0, :, 0].set(1.0)
    opts = Options(rtol=1e-10, atol=1e-13, pivoting=False, qr_fallback=True)
    sol = solve_radau(rhs, 0.0, 2.0, Y0, mass=MASS, options=opts,
                      tangents=seeds)
    assert bool(jnp.all(sol.status == SUCCESS))
    # ∂y(T)/∂y0(0): from the exact flow, dy0(t)/da = e^{-t}, dy1/da = 0
    np.testing.assert_allclose(np.asarray(sol.sens[0, :, 0]),
                               np.exp(-2.0), rtol=1e-7)
    np.testing.assert_allclose(np.asarray(sol.sens[0, :, 1]), 0.0,
                               atol=1e-9)


def test_qr_fallback_default_off_is_untouched():
    """Flag off: the pivoted path is unchanged (state carries 0-size QR
    slots) and still solves the permuted-mass system via pivoting."""
    sol = solve_radau(rhs, 0.0, 2.0, Y0, mass=MASS,
                      options=Options(rtol=1e-9, atol=1e-12, pivoting=True))
    assert bool(jnp.all(sol.status == SUCCESS))
    for i in range(2):
        np.testing.assert_allclose(np.asarray(sol.y[i]),
                                   exact(2.0, np.asarray(Y0[i])),
                                   rtol=1e-8, atol=1e-11)


# ---- Options(pallas_lu=...) wiring (shares this file: the other stage-
# solve override; the kernel itself is covered by tests/test_pallas_ops.py) --

def test_pallas_lu_option_validation():
    f = lambda t, y, a: -y                              # noqa: E731
    y0 = jnp.zeros((1, 2))
    with pytest.raises(ValueError):                     # kernel is pivot-free
        config.use_stage_lu_kernel(Options(pallas_lu=True, pivoting=True),
                                   platform="gpu")
    with mock.patch.object(config, "backend", lambda: "gpu"):
        with pytest.raises(ValueError):          # one override at a time
            solve_radau(f, 0.0, 1.0, y0,
                        options=Options(pallas_lu=True, pivoting=False,
                                        qr_fallback=True))
        with pytest.raises(ValueError):          # LU path only
            solve_radau(f, 0.0, 1.0, y0,
                        options=Options(pallas_lu=True, pivoting=False,
                                        stage_solver="tridiag"))
        from janus_tpu.solve import solve_ivp
        for method in ("radaup", "dopri5", "bdf2", "grk4t"):
            with pytest.raises(ValueError, match="pallas_lu"):  # no kernel
                solve_ivp(f, (0.0, 1.0), y0, method=method,
                          options=Options(pallas_lu=True, pivoting=False))


@pytest.mark.parametrize("method", ["radau", "rodas", "bdf", "seulex"])
def test_pallas_lu_option_raises_off_gpu(method):
    """The kernel exists for the GPU only: asking for it elsewhere raises
    instead of silently running the plain LU."""
    from janus_tpu.models.problems import vdp_rhs
    from janus_tpu.solve import solve_ivp

    y0 = jnp.array([[2.0, 0.0]])
    with pytest.raises(ValueError, match="GPU only"):
        solve_ivp(vdp_rhs, (0.0, 1.0), y0, method=method, args=100.0,
                  options=Options(rtol=1e-8, atol=1e-11, pivoting=False,
                                  pallas_lu=True))
