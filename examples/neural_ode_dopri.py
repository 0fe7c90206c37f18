"""Neural ODE trained through the ADAPTIVE Dormand-Prince solver.

The torchdiffeq/diffrax workflow the reference has no counterpart for
(its explicit family carries forward duals only, dopri853ted.hpp): fit an
MLP vector field to trajectory samples of an unknown flow by reverse-mode
differentiation THROUGH the adaptive dopri5 solve — `dopri_adjoint`
(solve/adjoint_dopri.py), the discrete adjoint on the recorded
accepted-step mesh, with `t_eval=` chained warm-started segments so every
sample is an exact solve endpoint.

Why this beats a fixed-grid neural ODE: the step controller concentrates
work where the learned field is fast — the gradient is exact for the
computed loss (discretize-then-optimize) at whatever tolerance is asked,
and the SAME code later serves stiff learned dynamics by swapping in
`rodas_adjoint`/`radau_adjoint` (identical calling convention).

  python examples/neural_ode_dopri.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # repo root

import jax

from janus_tpu import config  # noqa: E402

config.use_default_dtype()
import jax.numpy as jnp
import numpy as np
import optax

from janus_tpu.models.neural import mlp_apply, mlp_init
from janus_tpu.solve import Options
from janus_tpu.solve.adjoint_dopri import dopri_adjoint
from janus_tpu.solve.dopri import TABLEAUS, solve_erk

T_FINAL = 3.0
N_SAMPLE = 8          # trajectory samples per lane
M = 16                # batch of initial conditions
OPTS = Options(rtol=1e-6, atol=1e-9, adjoint_steps=32)


def true_rhs(t, y, args):
    """Ground truth: a damped spiral with a mild cubic twist."""
    a = jnp.stack([-0.1 * y[..., 0] + 2.0 * y[..., 1],
                   -2.0 * y[..., 0] - 0.1 * y[..., 1]
                   - 0.3 * y[..., 1] ** 3], axis=-1)
    return a


def nn_rhs(t, y, params):
    return mlp_apply(params, y)


def make_data(key):
    y0 = jax.random.uniform(key, (M, 2), minval=-1.5, maxval=1.5)
    ts = jnp.linspace(T_FINAL / N_SAMPLE, T_FINAL, N_SAMPLE)
    sol = solve_erk(TABLEAUS["dopri5"], true_rhs, jnp.zeros(M),
                    jnp.full(M, T_FINAL), y0, None,
                    Options(rtol=1e-9, atol=1e-12), t_eval=ts)
    assert np.all(np.asarray(sol.status) == 1)
    return y0, ts, sol.ys


def main(steps=400, seed=0, verbose=True, reg=0.0):
    """reg > 0 adds a kinetic-energy running cost λ·∫‖f_θ(y)‖² dt to the
    fitting loss via ``dopri_adjoint(cost=)`` — the Lagrange-term
    regularizer of "How to Train Your Neural ODE" (Finlay et al. 2020)
    that straightens learned trajectories and cuts solver steps. The
    integral's gradient flows through the SAME backward sweep as the fit
    (q̄ pulled through each recorded step's replayed GL-3 increment) — no
    state augmentation, no second solve; the reverse twin of the CVODES
    quadrature sensitivities (reference
    examples/cpp/for_sens_vdp_example.cpp:1-38)."""
    key = jax.random.PRNGKey(seed)
    k_data, k_net = jax.random.split(key)
    y0, ts, ys_true = make_data(k_data)
    params = mlp_init(k_net, [2, 64, 64, 2], dtype=ys_true.dtype)

    def kinetic(t, y, params):
        return jnp.sum(mlp_apply(params, y) ** 2, axis=-1)

    def loss_fn(params):
        if reg > 0.0:
            ys, q = dopri_adjoint(nn_rhs, (0.0, T_FINAL), y0, args=params,
                                  options=OPTS, t_eval=ts, method="dopri5",
                                  cost=kinetic)
            return jnp.mean((ys - ys_true) ** 2) + reg * jnp.mean(q)
        ys = dopri_adjoint(nn_rhs, (0.0, T_FINAL), y0, args=params,
                           options=OPTS, t_eval=ts, method="dopri5")
        return jnp.mean((ys - ys_true) ** 2)

    opt = optax.adam(3e-3)
    opt_state = opt.init(params)

    @jax.jit
    def update(params, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    loss0 = None
    for i in range(steps):
        params, opt_state, loss = update(params, opt_state)
        if loss0 is None:
            loss0 = float(loss)
        if verbose and (i % 50 == 0 or i == steps - 1):
            print(f"step {i:4d}  loss {float(loss):.3e}")
    lossN = float(loss)

    # held-out rollout: fresh initial conditions through the learned field
    k_test = jax.random.PRNGKey(seed + 1)
    y0_test = jax.random.uniform(k_test, (M, 2), minval=-1.2, maxval=1.2)
    sol_true = solve_erk(TABLEAUS["dopri5"], true_rhs, jnp.zeros(M),
                         jnp.full(M, T_FINAL), y0_test, None,
                         Options(rtol=1e-9, atol=1e-12), t_eval=ts)
    sol_nn = solve_erk(TABLEAUS["dopri5"], nn_rhs, jnp.zeros(M),
                       jnp.full(M, T_FINAL), y0_test, params, OPTS,
                       t_eval=ts)
    holdout = float(jnp.mean((sol_nn.ys - sol_true.ys) ** 2))
    if verbose:
        print(f"loss {loss0:.3e} -> {lossN:.3e}  holdout MSE {holdout:.3e}")
    return loss0, lossN, holdout


if __name__ == "__main__":
    config.enable_compile_cache()
    main()
