"""Stage-LU Pallas kernels (Triton route): interpret mode here, compiled on
the GPU by the ``gpu``-marked test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from janus_tpu import ops
from janus_tpu.linalg import smalllu


def _system(rng, m, d, dtype=jnp.float32, shift=5.0):
    a = jnp.asarray(rng.standard_normal((m, d, d)), dtype) \
        + shift * jnp.eye(d, dtype=dtype)
    b = jnp.asarray(rng.standard_normal((m, d)), dtype)
    return a, b


def _solve(a, b, interpret=True, **kw):
    return ops.lu_solve(ops.lu_factor(a, interpret=interpret, **kw), b,
                        interpret=interpret, **kw)


@pytest.mark.parametrize("d", [2, 3, 4, 6])
def test_fused_solve_matches_numpy(rng, d):
    a, b = _system(rng, 1024, d)
    expect = np.linalg.solve(np.asarray(a, np.float64),
                             np.asarray(b, np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(_solve(a, b), expect, rtol=2e-4, atol=2e-4)


def test_factor_then_solve(rng):
    """Packed factors equal ``linalg.smalllu.lu_factor(pivot=False)``'s, so
    the solvers' plain ``lu_solve`` can consume them."""
    a, b = _system(rng, 512, 3, jnp.float64, shift=4.0)
    lu = ops.lu_factor(a, interpret=True)
    lu_ref, piv = smalllu.lu_factor(a, pivot=False)
    np.testing.assert_allclose(lu, lu_ref, rtol=1e-13, atol=1e-13)
    np.testing.assert_allclose(ops.lu_solve(lu, b, interpret=True),
                               smalllu.lu_solve(lu_ref, piv, b),
                               rtol=1e-13, atol=1e-13)


def test_nonmultiple_tile_batch(rng):
    """A batch that is not a multiple of the lane block still works."""
    a, b = _system(rng, 700, 2, shift=4.0)
    expect = np.linalg.solve(np.asarray(a, np.float64),
                             np.asarray(b, np.float64)[..., None])[..., 0]
    np.testing.assert_allclose(_solve(a, b), expect, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("d", [2, 3, 6])
def test_padding_wrapper(rng, d):
    """D·D ∈ {4, 9, 36} entries pad to a power of two and M to a multiple
    of the block; the result is sliced back to the caller's shape."""
    m, block = 300, 64
    rows, cols = ops.padded_shape(m, d * d, block)
    assert rows % block == 0 and rows - block < m <= rows
    assert cols & (cols - 1) == 0 and cols // 2 < d * d <= cols
    a, b = _system(rng, m, d, jnp.float64)
    lu = ops.lu_factor(a, interpret=True, block_m=block)
    assert lu.shape == a.shape
    x = ops.lu_solve(lu, b, interpret=True, block_m=block)
    assert x.shape == b.shape
    lu_ref, piv = smalllu.lu_factor(a, pivot=False)
    np.testing.assert_allclose(x, smalllu.lu_solve(lu_ref, piv, b),
                               rtol=1e-12, atol=1e-12)


def test_batched_leading_axes(rng):
    """[M, P, D, D] stage blocks (the complex Radau pairs) keep their axes."""
    a, b = _system(rng, 96, 4, jnp.float64)
    a, b = a.reshape(48, 2, 4, 4), b.reshape(48, 2, 4)
    x = _solve(a, b)
    assert x.shape == (48, 2, 4)
    np.testing.assert_allclose(
        x, np.linalg.solve(np.asarray(a), np.asarray(b)[..., None])[..., 0],
        rtol=1e-12, atol=1e-12)


def test_triton_lowering_at_real_width():
    """The kernels lower to Triton for CUDA at the headline width, even on
    a host without a GPU (power-of-two blocks; no interpret fallback)."""
    a = jax.ShapeDtypeStruct((65536, 3, 3), jnp.float64)
    b = jax.ShapeDtypeStruct((65536, 3), jnp.float64)
    lowered = jax.jit(lambda a, b: ops.lu_solve(ops.lu_factor(a), b)).trace(
        a, b).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "stage_lu_factor" in text and "stage_lu_solve" in text


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_lu_on_gpu():
    m, d = 65536, 6
    a = jax.random.normal(jax.random.PRNGKey(0), (m, d, d), jnp.float64) \
        + 2.0 * d * jnp.eye(d)
    b = jax.random.normal(jax.random.PRNGKey(1), (m, d), jnp.float64)
    lu_ref, piv = smalllu.lu_factor(a, pivot=False)
    np.testing.assert_allclose(_solve(a, b, interpret=False),
                               smalllu.lu_solve(lu_ref, piv, b),
                               rtol=1e-12, atol=1e-12)


def test_padded_lanes_stay_finite():
    """Padded lanes carry the identity (matrices) and zeros (right-hand
    sides), so the padded block holds no inf/NaN."""
    from janus_tpu.ops import smalllu_pallas as k

    a = jnp.ones((5, 3, 3)) + 3.0 * jnp.eye(3)
    x = k._pad(a.reshape(5, 9), 8, k._eye_lane(3))
    assert x.shape == (8, 16)
    np.testing.assert_array_equal(x[5:, :9],
                                  np.tile(np.eye(3).ravel(), (3, 1)))
    np.testing.assert_array_equal(x[:, 9:], 0.0)
    lu = ops.lu_factor(a, interpret=True, block_m=8)
    assert bool(jnp.all(jnp.isfinite(lu)))


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["radau9", "rodas", "bdf", "seulex"])
def test_kernel_lu_solvers_match_plain_lu_on_gpu(method):
    """Every solver that takes ``pallas_lu`` gives the plain LU's answer,
    states and IND tangents."""
    from janus_tpu.models.problems import vdp_jac, vdp_rhs
    from janus_tpu.solve import SUCCESS, Options, solve_ivp

    m = 256
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))
    mus = jnp.logspace(1.0, 3.0, m)
    seeds = jnp.stack([jnp.zeros_like(y0).at[:, j].set(1.0)
                       for j in range(2)])
    sols = [solve_ivp(vdp_rhs, (0.0, 1.0), y0, method=method, args=mus,
                      jac=vdp_jac, tangents=seeds,
                      options=Options(rtol=1e-8, atol=1e-11, pivoting=False,
                                      pallas_lu=kernel))
            for kernel in (False, True)]
    for sol in sols:
        assert bool(jnp.all(sol.status == SUCCESS))
    np.testing.assert_allclose(sols[1].y, sols[0].y, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(sols[1].sens, sols[0].sens, rtol=1e-5,
                               atol=1e-8)
