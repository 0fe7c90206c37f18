"""Learned continuation-step controller (the reference's SSSC-ML workload).

The reference closes an ML loop around its continuation solvers
(reference examples/python/sssc_ml_vdp.py:1-132: generate homotopy run data,
train the DeltaNet MLP sssc_dnn_vdp_model.py:54-62 to predict the largest
safe continuation step Δλ_max, drive the solver with it). Same loop here,
batched:

1. DATA: for a training family of problem instances, probe — in ONE batched
   Newton correction over (instance × λ-grid × candidate-Δλ) lanes — which
   candidate steps the corrector survives; label = largest safe Δλ.
2. IO: write/read the dataset through the native binary trajectory store
   (janus_tpu.native.traj_write — the reference's CSV round-trip role).
3. TRAIN: a small MLP (models.neural) maps features (λ, instance parameter)
   to log Δλ_max.
4. CLOSE THE LOOP: ``homotopy(dlam_fn=...)`` consults the trained policy
   after every accepted point; on held-out instances it takes FEWER
   continuation steps than the fixed-Δλ schedule (and no more retries).

Problem family: convex homotopy G(x,λ) = λF(x) + (1−λ)(x−x₀) on the
exponential system F(x) = [x₁ − a·e^{0.45·x₂}, x₂ − a·e^{0.45·x₁}]
(Bratu-style; the fold sits at a ≈ 0.82, so a ∈ [0.1, 0.8] spans easy to
hard) — the difficulty profile along λ varies with a, which is what the
policy learns.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax

from janus_tpu.control.homotopy import convex_homotopy, homotopy
from janus_tpu.control.newton import fd_or_ad_jacobian
from janus_tpu.linalg.smalllu import lu_factor, lu_ok, lu_solve
from janus_tpu.models.neural import mlp_apply, mlp_init

TOL = 1e-5   # f32-honest (the residual floor is ~eps*|x| ~ 2e-7)
CANDS = np.array([0.02, 0.04, 0.07, 0.12, 0.2, 0.3, 0.45, 0.7, 1.0])


def family_g(c):
    """Convex-homotopy residual for per-lane exponential instances a [M]."""
    def f(x):
        x1, x2 = x[..., 0], x[..., 1]
        return jnp.stack([x1 - c * jnp.exp(0.45 * x2),
                          x2 - c * jnp.exp(0.45 * x1)], axis=-1)
    return convex_homotopy(f, jnp.zeros((c.shape[0], 2)))


def corrector_survives(g, x, lam, iters=3):
    """One batched fixed-iteration Newton correction; True where it lands."""
    def nbody(_, carry):
        (xx,) = carry
        jm = fd_or_ad_jacobian(lambda z: g(z, lam), xx, "ad")
        lu, piv = lu_factor(jm)
        ok = lu_ok(lu)
        step = lu_solve(lu, piv, -g(xx, lam))
        return (xx + jnp.where(ok[:, None], step, 0.0),)
    (xf,) = jax.lax.fori_loop(0, iters, nbody, (x,))
    res = jnp.linalg.norm(g(xf, lam), axis=-1)
    return xf, jnp.isfinite(res) & (res < TOL)


def generate_dataset(cs, n_lam=12):
    """Probe Δλ_max over (instance, λ, candidate) in one batched sweep."""
    n_inst = cs.shape[0]
    lams = np.linspace(0.0, 0.95, n_lam)
    # corrected base points x(λ, c): walk each instance up the λ ladder
    g = family_g(jnp.asarray(cs))
    xs = [jnp.zeros((n_inst, 2))]
    for lam in lams[1:]:
        x, _ = corrector_survives(g, xs[-1], jnp.full((n_inst,), lam))
        xs.append(x)
    xs = jnp.stack(xs, axis=1)                   # [n_inst, n_lam, 2]

    # flatten (instance, λ, candidate) into ONE batched trial correction
    nc = len(CANDS)
    big_c = jnp.asarray(np.repeat(cs, n_lam * nc))
    big_x = jnp.reshape(jnp.repeat(xs[:, :, None, :], nc, axis=2),
                        (n_inst * n_lam * nc, 2))
    big_lam = jnp.asarray(np.minimum(
        lams[None, :, None] + CANDS[None, None, :], 1.0)
        .repeat(n_inst, axis=0).reshape(-1))
    big_g = family_g(big_c)
    _, ok = corrector_survives(big_g, big_x, big_lam)
    ok = np.asarray(ok).reshape(n_inst, n_lam, nc)

    feats, labels = [], []
    for i in range(n_inst):
        for j, lam in enumerate(lams):
            good = CANDS[ok[i, j]]
            label = good.max() if good.size else CANDS[0] * 0.5
            feats.append([lam, cs[i]])
            labels.append(np.log(label))
    return np.asarray(feats), np.asarray(labels)


def train_policy(feats, labels, seed=0, steps=500):
    params = mlp_init(jax.random.PRNGKey(seed), [2, 16, 16, 1],
                      jnp.float32)
    x = jnp.asarray(feats, jnp.float32)
    y = jnp.asarray(labels, jnp.float32)

    def loss(p):
        pred = mlp_apply(p, x)[:, 0]
        return jnp.mean((pred - y) ** 2)

    opt = optax.adam(1e-2)
    st = opt.init(params)

    @jax.jit
    def step(p, s):
        l, grads = jax.value_and_grad(loss)(p)
        up, s = opt.update(grads, s)
        return optax.apply_updates(p, up), s, l

    for _ in range(steps):
        params, st, l = step(params, st)
    return params, float(l)


def main():
    rng = np.random.default_rng(0)
    cs_train = rng.uniform(0.1, 0.8, size=48)
    cs_test = np.linspace(0.15, 0.79, 16)

    feats, labels = generate_dataset(cs_train)
    # dataset round-trip through the native binary store
    path = os.path.join(tempfile.gettempdir(), "sssc_ml_dataset.bin")
    from janus_tpu import native
    recs = np.concatenate([feats, labels[:, None]], axis=1)
    native.traj_write(path, recs)
    back = native.traj_read(path)
    assert np.allclose(back, recs)
    feats, labels = back[:, :2], back[:, 2]
    print(f"dataset: {len(labels)} probes  "
          f"(Δλ_max range {np.exp(labels).min():.3f}..{np.exp(labels).max():.3f})")

    params, final_loss = train_policy(feats, labels)
    print(f"policy trained, mse(log Δλ) = {final_loss:.4f}")

    ct = jnp.asarray(cs_test)
    g_test = family_g(ct)
    x0 = jnp.zeros((len(cs_test), 2))

    # learned policy: predict Δλ_max at the NEW point, keep a safety margin
    def dlam_policy(x, lam, dlam):
        f = jnp.stack([lam, ct], axis=-1).astype(jnp.float32)
        pred = jnp.exp(mlp_apply(params, f)[:, 0]).astype(x.dtype)
        return 0.8 * pred

    r_fixed = homotopy(g_test, x0, dlam0=0.05, tol=TOL,
                       dlam_fn=lambda x, lam, d: jnp.full_like(d, 0.05))
    r_react = homotopy(g_test, x0, dlam0=0.05, tol=TOL)
    r_ml = homotopy(g_test, x0, dlam0=0.05, tol=TOL,
                    dlam_fn=dlam_policy)

    for name, r in [("fixed Δλ=0.05", r_fixed), ("reactive 1.5x/0.5x",
                                                 r_react),
                    ("learned policy", r_ml)]:
        print(f"{name:22s}: converged {int(r.converged.sum())}/{len(cs_test)}"
              f", mean steps {float(r.iters.mean()):.1f}")
    assert bool(jnp.all(r_ml.converged))
    assert float(r_ml.iters.mean()) < float(r_fixed.iters.mean())
    print("learned policy beats the fixed schedule ✓")
    return r_fixed, r_react, r_ml


if __name__ == "__main__":
    main()
