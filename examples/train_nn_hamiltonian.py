"""End-to-end L4 workflow: learn a neural-network Hamiltonian from solver data.

The reference's NN pipeline (vdp_sssc_data.py → CSV → sssc_dnn_vdp_model.py)
re-done with the full batched stack:

1. generate ground-truth flow segments with the adaptive Radau solver;
2. persist them through the native binary dataset IO (C++ traj_write);
3. train an MLP Hamiltonian through the checkpointed fixed-step integrator
   (reverse-mode AD through the solve);
4. checkpoint (npz); verify the learned field on held-out states.

  python examples/train_nn_hamiltonian.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import tempfile

import jax

from janus_tpu import config  # noqa: E402

config.use_default_dtype()
import jax.numpy as jnp
import numpy as np
import optax

from janus_tpu import native
from janus_tpu.models.neural import mlp_init, mlp_apply
from janus_tpu.models.problems import harmonic_rhs
from janus_tpu.solve import solve_ivp
from janus_tpu.solve.fixed import odeint_fixed
from janus_tpu.utils import save_checkpoint, restore_checkpoint


def nn_rhs(t, y, params):
    """Canonical dynamics from the learned H: q' = ∂H/∂v, v' = −∂H/∂q."""
    def h_single(yy):
        return jnp.sum(mlp_apply(params, yy))

    def single(yy):
        g = jax.grad(h_single)(yy)
        return jnp.stack([g[1], -g[0]])

    return jax.vmap(single)(y)


def main(steps=400, m=256, dt=0.5, workdir=None):
    key = jax.random.PRNGKey(0)
    workdir = Path(workdir or tempfile.mkdtemp(prefix="janus_train_"))

    # 1) ground truth from the ADAPTIVE solver (radau, tight tolerance)
    key, k1 = jax.random.split(key)
    y0s = jax.random.normal(k1, (m, 2), jnp.float64)
    sol = solve_ivp(harmonic_rhs, (0.0, dt), y0s, method="radau", args=1.0,
                    rtol=1e-10, atol=1e-13)
    assert bool(jnp.all(sol.status == 1))

    # 2) dataset round-trip through the native IO
    ds_path = workdir / "flow_pairs.jtrj"
    native.traj_write(ds_path, np.hstack([np.asarray(y0s),
                                          np.asarray(sol.y)]))
    data = native.traj_read(ds_path)
    x_train = jnp.asarray(data[:, :2])
    y_train = jnp.asarray(data[:, 2:])
    print(f"dataset: {data.shape[0]} flow pairs via {ds_path}")

    # 3) train through the fixed-step (reverse-differentiable) integrator
    params = mlp_init(key, [2, 32, 32, 1], jnp.float64)
    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    def loss_fn(p):
        pred = odeint_fixed(nn_rhs, 0.0, dt, x_train, n_steps=16, args=p)
        return jnp.mean((pred - y_train) ** 2)

    @jax.jit
    def step(p, s):
        l, g = jax.value_and_grad(loss_fn)(p)
        up, s = opt.update(g, s)
        return optax.apply_updates(p, up), s, l

    l0 = float(loss_fn(params))
    for i in range(steps):
        params, opt_state, l = step(params, opt_state)
        if i % 100 == 0:
            print(f"step {i:4d}  loss {float(l):.3e}")
    print(f"loss: {l0:.3e} -> {float(l):.3e}  ({l0/float(l):.0f}x)")

    # 4) checkpoint + restore + held-out verification
    ckpt = workdir / "ckpt"
    save_checkpoint(ckpt, params, step=steps)
    params2 = restore_checkpoint(ckpt, template=params)
    ytest = jnp.array([[0.8, -0.4], [-1.2, 0.3]])
    pred = odeint_fixed(nn_rhs, 0.0, dt, ytest, n_steps=64, args=params2)
    true = odeint_fixed(harmonic_rhs, 0.0, dt, ytest, n_steps=64, args=1.0)
    err = float(jnp.max(jnp.abs(pred - true)))
    print(f"held-out flow error after restore: {err:.2e}")
    assert err < 0.05
    return err


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
