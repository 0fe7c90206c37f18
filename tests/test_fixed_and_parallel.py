"""Fixed-step reverse-mode path + virtual 8-device mesh sharding tests.

The reference has exactly one multi-process test (mpi_petsc_test.py:1-40, a
gather sanity check); here the sharded path runs the real solver on the CPU
mesh and checks bitwise-equivalent results vs single-device."""

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from janus_tpu.models.problems import harmonic_rhs, vdp_rhs
from janus_tpu.parallel import make_mesh, shard_batch
from janus_tpu.solve import solve_ivp, Options
from janus_tpu.solve.fixed import odeint_fixed


def test_fixed_rk4_accuracy():
    omega = 2.0
    y0 = jnp.array([[1.0, 0.0], [0.5, 0.0]])
    yT = odeint_fixed(harmonic_rhs, 0.0, 1.0, y0, n_steps=200, args=omega)
    np.testing.assert_allclose(yT[:, 0], np.asarray(y0)[:, 0] * np.cos(2.0),
                               rtol=1e-7)


def test_fixed_reverse_grad_matches_fd():
    omega = 1.0

    def loss(y0flat):
        y0 = y0flat.reshape(1, 2)
        yT = odeint_fixed(harmonic_rhs, 0.0, 1.0, y0, n_steps=64, args=omega)
        return jnp.sum(yT ** 2)

    y0 = jnp.array([1.0, 0.5])
    g = jax.grad(loss)(y0)
    eps = 1e-6
    for i in range(2):
        e = jnp.zeros(2).at[i].set(eps)
        fd = (loss(y0 + e) - loss(y0 - e)) / (2 * eps)
        np.testing.assert_allclose(g[i], fd, rtol=1e-6, atol=1e-9)


def test_fixed_step_args_slabs():
    """Per-step parameter slabs (piecewise-constant controls)."""
    def rhs(t, y, args):
        base, slab = args
        return jnp.broadcast_to(slab, y.shape)

    slabs = jnp.linspace(0.0, 1.0, 10)[:, None]      # [n_steps, 1]
    yT = odeint_fixed(rhs, 0.0, 1.0, jnp.zeros((3, 1)), n_steps=10,
                      args=None, step_args=slabs)
    # ∫ u dt with u piecewise = mean of slabs
    np.testing.assert_allclose(yT[:, 0], float(jnp.mean(slabs)) * 1.0,
                               rtol=1e-12)


def test_sharded_solve_matches_single_device():
    mesh = make_mesh(8)
    m = 32
    mus = jnp.linspace(1.0, 50.0, m)
    y0 = jnp.tile(jnp.array([[2.0, 0.0]]), (m, 1))

    sol_ref = solve_ivp(vdp_rhs, (0.0, 2.0), y0, method="radau", args=mus,
                        rtol=1e-7, atol=1e-10)

    y0s = shard_batch(y0, mesh)
    muss = shard_batch(mus, mesh)

    @jax.jit
    def run(y0, mus):
        sol = solve_ivp(vdp_rhs, (0.0, 2.0), y0, method="radau", args=mus,
                        rtol=1e-7, atol=1e-10)
        return sol.y, sol.status

    ys, status = run(y0s, muss)
    assert bool(jnp.all(status == 1))
    np.testing.assert_allclose(ys, sol_ref.y, rtol=1e-10, atol=1e-12)
    # result really is sharded over the mesh
    assert len(ys.sharding.device_set) == 8


def test_graft_entry_dryrun():
    """The multi-device dry run must pass on the virtual mesh."""
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    assert all(bool(jnp.all(jnp.isfinite(o))) for o in out[:2])
    ge.dryrun_multichip(8)
