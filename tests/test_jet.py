"""Jet arithmetic property tests: tangents vs finite differences and jax.jvp.

Mirrors the reference's FD-vs-AD oracle pattern (reference
tests/cpp/ode_solver_test.cpp:46-94) but as parametrized pytest properties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from janus_tpu import jet as J
from janus_tpu.jet.core import maximum, minimum


def make_jet(rng, shape=(4, 3), n=5):
    r = jnp.asarray(rng.standard_normal(shape))
    d = jnp.asarray(rng.standard_normal((n,) + shape))
    return J.jet(r, d)


def fd_directional(f, r, v, eps=1e-6):
    return (f(r + eps * v) - f(r - eps * v)) / (2 * eps)


UNARY = [
    lambda z: z + 2.5,
    lambda z: 2.5 - z,
    lambda z: z * 3.0,
    lambda z: z / 1.7,
    lambda z: 1.0 / z,
    lambda z: -z,
    lambda z: z ** 3,
    lambda z: z.exp() if isinstance(z, J.Jet) else jnp.exp(z),
    lambda z: z.sin() if isinstance(z, J.Jet) else jnp.sin(z),
    lambda z: z.cos() if isinstance(z, J.Jet) else jnp.cos(z),
    lambda z: z.tanh() if isinstance(z, J.Jet) else jnp.tanh(z),
    lambda z: z.square() if isinstance(z, J.Jet) else jnp.square(z),
    lambda z: z.reciprocal() if isinstance(z, J.Jet) else 1.0 / z,
]


@pytest.mark.parametrize("op_idx", range(len(UNARY)))
def test_unary_tangents_match_jvp(rng, op_idx):
    op = UNARY[op_idx]
    x = make_jet(rng)
    x = J.jet(jnp.abs(x.r) + 0.5, x.d)  # keep domain positive
    out = op(x)
    for k in range(x.nsens):
        _, expect = jax.jvp(op, (x.r,), (x.d[k],))
        np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)


def test_sqrt_log_abs(rng):
    x = make_jet(rng)
    xp = J.jet(jnp.abs(x.r) + 0.5, x.d)
    for op, ref in [(lambda z: z.sqrt(), jnp.sqrt),
                    (lambda z: z.log(), jnp.log)]:
        out = op(xp)
        for k in range(xp.nsens):
            _, expect = jax.jvp(ref, (xp.r,), (xp.d[k],))
            np.testing.assert_allclose(out.d[k], expect, rtol=1e-10)
    out = abs(x)
    np.testing.assert_allclose(out.r, jnp.abs(x.r))
    np.testing.assert_allclose(out.d, x.d * jnp.sign(x.r))


def test_binary_jet_jet(rng):
    a = make_jet(rng)
    b = make_jet(rng)
    b = J.jet(b.r + 3.0, b.d)
    for op in [lambda u, v: u + v, lambda u, v: u - v,
               lambda u, v: u * v, lambda u, v: u / v]:
        out = op(a, b)
        for k in range(a.nsens):
            _, expect = jax.jvp(op, (a.r, b.r), (a.d[k], b.d[k]))
            np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)


def test_matmul_einsum(rng):
    a = J.jet(jnp.asarray(rng.standard_normal((2, 3, 4))),
              jnp.asarray(rng.standard_normal((5, 2, 3, 4))))
    b = J.jet(jnp.asarray(rng.standard_normal((2, 4, 6))),
              jnp.asarray(rng.standard_normal((5, 2, 4, 6))))
    out = a @ b
    oute = J.einsum("bij,bjk->bik", a, b)
    f = lambda x, y: x @ y
    for k in range(5):
        _, expect = jax.jvp(f, (a.r, b.r), (a.d[k], b.d[k]))
        np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(oute.d[k], expect, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(out.r, a.r @ b.r, rtol=1e-12)


def test_lift_generic(rng):
    x = make_jet(rng)
    f = lambda z: jnp.sum(jnp.sin(z) * z, axis=-1)
    out = J.lift(f, x)
    np.testing.assert_allclose(out.r, f(x.r), rtol=1e-12)
    for k in range(x.nsens):
        _, expect = jax.jvp(f, (x.r,), (x.d[k],))
        np.testing.assert_allclose(out.d[k], expect, rtol=1e-10, atol=1e-12)


def test_lift_mixed_const(rng):
    x = make_jet(rng)
    c = jnp.asarray(rng.standard_normal((4, 3)))
    out = J.lift(lambda a, b: a * b + jnp.cos(b), x, c)
    np.testing.assert_allclose(out.r, x.r * c + jnp.cos(c), rtol=1e-12)
    for k in range(x.nsens):
        np.testing.assert_allclose(out.d[k], x.d[k] * c, rtol=1e-10, atol=1e-12)


def test_where_select(rng):
    a = make_jet(rng)
    b = make_jet(rng)
    cond = a.r > 0
    out = J.where(cond, a, b)
    np.testing.assert_allclose(out.r, jnp.where(cond, a.r, b.r))
    np.testing.assert_allclose(out.d, jnp.where(cond[None], a.d, b.d))


def test_concat_stack_sum(rng):
    a = make_jet(rng, (4, 3))
    b = make_jet(rng, (4, 2))
    c = J.concatenate([a, b], axis=-1)
    assert c.shape == (4, 5)
    assert c.d.shape == (5, 4, 5)
    s = a.sum(axis=-1)
    np.testing.assert_allclose(s.r, a.r.sum(-1))
    np.testing.assert_allclose(s.d, a.d.sum(-1))


def test_max_min_dual(rng):
    a = make_jet(rng, (6, 4))
    mx = J.max_dual(a, axis=-1)
    idx = jnp.argmax(a.r, axis=-1)
    np.testing.assert_allclose(mx.r, jnp.max(a.r, axis=-1))
    for m in range(6):
        np.testing.assert_allclose(mx.d[:, m], a.d[:, m, idx[m]])
    mn = minimum(a, a.const_like(0.0))
    np.testing.assert_allclose(mn.r, jnp.minimum(a.r, 0.0))


def test_seed_identity():
    y = jnp.arange(6.0).reshape(2, 3)
    jt = J.seed_identity(y, extra=2)
    assert jt.nsens == 5
    np.testing.assert_allclose(jt.d[0, :, 0], 1.0)
    np.testing.assert_allclose(jt.d[1, :, 0], 0.0)
    np.testing.assert_allclose(jt.d[3], 0.0)  # extra column zero-seeded


def test_jet_through_scan(rng):
    """Jets must flow through lax control flow (pytree registration)."""
    x = make_jet(rng, (3,), n=2)

    def step(carry, _):
        return carry * 1.1 + 0.1, None

    out, _ = jax.lax.scan(step, x, None, length=5)
    expect = x
    for _ in range(5):
        expect = expect * 1.1 + 0.1
    np.testing.assert_allclose(out.r, expect.r, rtol=1e-12)
    np.testing.assert_allclose(out.d, expect.d, rtol=1e-12)


def test_jet_fd_property(rng):
    """Full FD-vs-tangent property on a composite expression."""
    x = make_jet(rng, (8,), n=3)
    g = lambda z: jnp.tanh(z) * jnp.exp(-0.5 * z * z) + z / (1.0 + z * z)
    out = J.lift(g, x)
    for k in range(3):
        fd = fd_directional(g, np.asarray(x.r), np.asarray(x.d[k]))
        np.testing.assert_allclose(out.d[k], fd, rtol=1e-6, atol=1e-8)


def test_matmul_einsum_use_highest_precision(rng):
    """Repo precision rule (CLAUDE.md): jet contractions must request
    Precision.HIGHEST so XLA cannot run f32 einsums at reduced precision.
    Structural pin: every dot_general in the lowered jaxpr carries it."""
    a = make_jet(rng, (4, 5), n=2)
    b = make_jet(rng, (5, 3), n=2)

    def count_dots(jaxpr, hits=None):
        hits = [] if hits is None else hits
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                hits.append(eqn.params.get("precision"))
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):
                    count_dots(v.jaxpr, hits)
        return hits

    for fn in (lambda x, y: J.matmul(x, y),
               lambda x, y: J.einsum("ij,jk->ik", x, y)):
        precs = count_dots(jax.make_jaxpr(fn)(a, b).jaxpr)
        assert precs, "expected dot_general ops in jet contraction"
        for p in precs:
            assert p is not None and all(
                pi == jax.lax.Precision.HIGHEST for pi in p), p


def test_jet_f32_on_chip_dtype(rng):
    """float32 regression: jet arithmetic in float32 must stay at f32
    accuracy (the HIGHEST-precision contractions keep XLA from running f32
    einsums at reduced precision — here we pin the numerics in f32, vs an
    f64 oracle)."""
    a64 = make_jet(rng, (16, 8), n=3)
    b64 = make_jet(rng, (8, 4), n=3)
    to32 = lambda j: J.Jet(jnp.asarray(j.r, jnp.float32),
                           jnp.asarray(j.d, jnp.float32))
    a32, b32 = to32(a64), to32(b64)

    out64 = J.matmul(a64, b64)
    out32 = J.matmul(a32, b32)
    # f32 matmul over K=8 accumulations: ~1e-6 relative; bf16 demotion
    # would show up at ~1e-2
    np.testing.assert_allclose(np.asarray(out32.r), np.asarray(out64.r),
                               rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(np.asarray(out32.d), np.asarray(out64.d),
                               rtol=3e-5, atol=3e-5)

    g = lambda z: jnp.tanh(z) * jnp.exp(-0.5 * z) + z * z
    l64 = J.lift(g, a64)
    l32 = J.lift(g, a32)
    np.testing.assert_allclose(np.asarray(l32.r), np.asarray(l64.r),
                               rtol=3e-6, atol=3e-6)
    np.testing.assert_allclose(np.asarray(l32.d), np.asarray(l64.d),
                               rtol=3e-5, atol=3e-5)
