"""Jet: batched first-order dual numbers carrying N forward sensitivities.

Layout
------
``Jet(r, d)`` with ``r.shape == S`` (any shape, typically ``[M, D]`` for a batch of
M trajectories of state dim D) and ``d.shape == (N, *S)`` — the sensitivity axis is
LEADING, unlike the reference's trailing layout (TensorDual r:[M,D], d:[M,D,N];
reference src/cpp/radauted.hpp:241-296). A leading axis makes every tangent column
an ordinary ``jax.jvp`` tangent, so generic lifting is a ``vmap`` over axis 0 of
``d`` and XLA lays the N copies out contiguously for vector units.

Semantics: a Jet represents the family ``x(ε) = r + Σ_n ε_n d[n]`` to first order.
All ops propagate d by the chain rule. Comparisons act on ``r`` only (branching on
sensitivities is meaningless), matching the reference's masked-control-flow usage.
"""

from __future__ import annotations

import operator
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.tree_util import register_pytree_node_class


def _is_jet(x: Any) -> bool:
    return isinstance(x, Jet)


@register_pytree_node_class
class Jet:
    """First-order jet (dual number with N tangent directions), a JAX pytree."""

    __slots__ = ("r", "d")

    def __init__(self, r, d):
        self.r = r
        self.d = d

    # -- pytree protocol -------------------------------------------------
    def tree_flatten(self):
        return (self.r, self.d), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- basic introspection ---------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.r)

    @property
    def dtype(self):
        return jnp.result_type(self.r)

    @property
    def ndim(self):
        return jnp.ndim(self.r)

    @property
    def nsens(self) -> int:
        """Number of sensitivity directions N."""
        return self.d.shape[0]

    def __repr__(self):
        return f"Jet(r={self.r!r}, d.shape={jnp.shape(self.d)})"

    # -- construction helpers --------------------------------------------
    def zeros_like(self) -> "Jet":
        return Jet(jnp.zeros_like(self.r), jnp.zeros_like(self.d))

    def ones_like(self) -> "Jet":
        return Jet(jnp.ones_like(self.r), jnp.zeros_like(self.d))

    def const_like(self, value) -> "Jet":
        return Jet(jnp.broadcast_to(jnp.asarray(value, self.dtype), self.shape),
                   jnp.zeros_like(self.d))

    # -- binary arithmetic -------------------------------------------------
    def _split(self, other):
        """Return (r_other, d_other-or-None) treating non-Jet as constant."""
        if _is_jet(other):
            return other.r, other.d
        return other, None

    def __add__(self, o):
        ro, do = self._split(o)
        d = self.d if do is None else self.d + do
        return Jet(self.r + ro, _bcast_d(d, jnp.shape(self.r + ro)))

    __radd__ = __add__

    def __sub__(self, o):
        ro, do = self._split(o)
        d = self.d if do is None else self.d - do
        return Jet(self.r - ro, _bcast_d(d, jnp.shape(self.r - ro)))

    def __rsub__(self, o):
        ro, _ = self._split(o)
        return Jet(ro - self.r, _bcast_d(-self.d, jnp.shape(ro - self.r)))

    def __mul__(self, o):
        ro, do = self._split(o)
        d = self.d * ro if do is None else self.d * ro + do * self.r
        return Jet(self.r * ro, _bcast_d(d, jnp.shape(self.r * ro)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        ro, do = self._split(o)
        inv = 1.0 / ro
        if do is None:
            d = self.d * inv
        else:
            d = (self.d - do * (self.r * inv)) * inv
        return Jet(self.r * inv, _bcast_d(d, jnp.shape(self.r * inv)))

    def __rtruediv__(self, o):
        ro, _ = self._split(o)
        r = ro / self.r
        return Jet(r, _bcast_d(-self.d * (r / self.r), jnp.shape(r)))

    def __pow__(self, e):
        if _is_jet(e):
            return lift(jnp.power, self, e)
        r = self.r ** e
        return Jet(r, _bcast_d(self.d * (e * self.r ** (e - 1)), jnp.shape(r)))

    def __neg__(self):
        return Jet(-self.r, -self.d)

    def __abs__(self):
        s = jnp.sign(self.r)
        return Jet(jnp.abs(self.r), self.d * s)

    def __matmul__(self, o):
        return matmul(self, o)

    def __rmatmul__(self, o):
        return matmul(o, self)

    # -- comparisons (on primal part) -------------------------------------
    def __lt__(self, o):
        return self.r < (o.r if _is_jet(o) else o)

    def __le__(self, o):
        return self.r <= (o.r if _is_jet(o) else o)

    def __gt__(self, o):
        return self.r > (o.r if _is_jet(o) else o)

    def __ge__(self, o):
        return self.r >= (o.r if _is_jet(o) else o)

    def __eq__(self, o):  # noqa: D105
        return self.r == (o.r if _is_jet(o) else o)

    def __ne__(self, o):
        return self.r != (o.r if _is_jet(o) else o)

    __hash__ = None

    # -- elementwise math --------------------------------------------------
    def _unary(self, fr: Callable, dfr: Callable) -> "Jet":
        return Jet(fr(self.r), self.d * dfr(self.r))

    def sqrt(self):
        r = jnp.sqrt(self.r)
        return Jet(r, self.d * (0.5 / r))

    def square(self):
        return Jet(jnp.square(self.r), self.d * (2.0 * self.r))

    def reciprocal(self):
        inv = 1.0 / self.r
        return Jet(inv, self.d * (-inv * inv))

    def exp(self):
        r = jnp.exp(self.r)
        return Jet(r, self.d * r)

    def log(self):
        return self._unary(jnp.log, lambda x: 1.0 / x)

    def sin(self):
        return self._unary(jnp.sin, jnp.cos)

    def cos(self):
        return self._unary(jnp.cos, lambda x: -jnp.sin(x))

    def tanh(self):
        return self._unary(jnp.tanh, lambda x: 1.0 - jnp.tanh(x) ** 2)

    def abs(self):
        return abs(self)

    # -- shaping -----------------------------------------------------------
    def __getitem__(self, idx):
        return Jet(self.r[idx], self.d[(slice(None),) + (idx if isinstance(idx, tuple) else (idx,))])

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        n = self.d.shape[0]
        return Jet(self.r.reshape(shape), self.d.reshape((n,) + tuple(shape)))

    def sum(self, axis=None, keepdims=False):
        return jet_sum(self, axis=axis, keepdims=keepdims)


def _bcast_d(d, rshape):
    """Broadcast tangent stack to (N, *rshape)."""
    n = d.shape[0]
    return jnp.broadcast_to(d, (n,) + tuple(rshape))


# -- constructors -----------------------------------------------------------

def jet(r, d) -> Jet:
    """Build a Jet from primal ``r`` and tangent stack ``d`` of shape (N, *r.shape)."""
    r = jnp.asarray(r)
    d = jnp.asarray(d)
    if d.shape[1:] != r.shape:
        raise ValueError(f"tangent shape {d.shape} incompatible with primal {r.shape}")
    return Jet(r, d)


def const(r, n: int) -> Jet:
    """A Jet with zero sensitivities (constant w.r.t. all N directions)."""
    r = jnp.asarray(r)
    return Jet(r, jnp.zeros((n,) + r.shape, r.dtype))


def seed_identity(y, extra: int = 0) -> Jet:
    """Seed identity sensitivities over the LAST axis of ``y``.

    For ``y: [M, D]`` returns a Jet with N = D + extra, where d[j, :, i] = δ_ij for
    j < D and zero for the ``extra`` trailing directions (e.g. parameter and
    final-time columns — the reference seeds a final-time column the same way,
    reference tests/cpp/ode_solver_test.cpp:620-647).
    """
    y = jnp.asarray(y)
    dim = y.shape[-1]
    n = dim + extra
    eye = jnp.eye(n, dim, dtype=y.dtype)  # [N, D]
    d = jnp.broadcast_to(
        eye.reshape((n,) + (1,) * (y.ndim - 1) + (dim,)), (n,) + y.shape
    )
    return Jet(y, d)


# -- generic lift -----------------------------------------------------------

def lift(f: Callable, *args, **kwargs):
    """Apply any JAX-traceable ``f`` to a mix of Jets and constants.

    Uses ``jax.linearize`` so the primal is evaluated once and the N tangents are
    pushed through the linearized graph with ``vmap`` over the leading axis —
    replacing the reference's per-op hand rules (janus-tensor-dual) in one shot.
    """
    jet_pos = [i for i, a in enumerate(args) if _is_jet(a)]
    if not jet_pos:
        return f(*args, **kwargs)
    n = args[jet_pos[0]].d.shape[0]

    def g(*jet_primals):
        full = list(args)
        for i, jp in zip(jet_pos, jet_primals):
            full[i] = jp
        return f(*full, **kwargs)

    primals = tuple(args[i].r for i in jet_pos)
    tangents = tuple(args[i].d for i in jet_pos)
    out_r, lin = jax.linearize(g, *primals)
    out_d = jax.vmap(lin)(*tangents)
    return jax.tree_util.tree_map(
        lambda r_, d_: Jet(r_, d_), out_r, out_d,
        is_leaf=lambda x: not isinstance(x, (tuple, list, dict)),
    )


def jvp_call(f: Callable, x: Jet, *const_args):
    """``f(x, *const_args)`` lifted over a single Jet argument (fast path)."""
    out_r, lin = jax.linearize(lambda xr: f(xr, *const_args), x.r)
    return Jet(out_r, jax.vmap(lin)(x.d))


# -- structured ops ---------------------------------------------------------

def _as_jet(x, n, dtype=None) -> Jet:
    if _is_jet(x):
        return x
    x = jnp.asarray(x, dtype)
    return Jet(x, jnp.zeros((n,) + x.shape, x.dtype))


def where(cond, a, b) -> Jet:
    """Elementwise select; cond is a plain boolean array (primal-level mask)."""
    cond = cond.r if _is_jet(cond) else cond
    n = (a if _is_jet(a) else b).d.shape[0]
    a = _as_jet(a, n)
    b = _as_jet(b, n)
    return Jet(jnp.where(cond, a.r, b.r), jnp.where(cond[None], a.d, b.d))


def concatenate(jets, axis=0) -> Jet:
    n = next(j.d.shape[0] for j in jets if _is_jet(j))
    jets = [_as_jet(j, n) for j in jets]
    daxis = axis if axis < 0 else axis + 1
    return Jet(
        jnp.concatenate([j.r for j in jets], axis=axis),
        jnp.concatenate([j.d for j in jets], axis=daxis),
    )


def stack(jets, axis=0) -> Jet:
    n = next(j.d.shape[0] for j in jets if _is_jet(j))
    jets = [_as_jet(j, n) for j in jets]
    daxis = axis if axis < 0 else axis + 1
    return Jet(
        jnp.stack([j.r for j in jets], axis=axis),
        jnp.stack([j.d for j in jets], axis=daxis),
    )


# XLA may run plain f32 einsums at reduced precision (TF32 on the GPU);
# solver-grade dual arithmetic (Newton residuals, sensitivity contractions)
# needs full f32 (repo rule — see CLAUDE.md and solve/radau.py).
_PRECISION = jax.lax.Precision.HIGHEST


def _einsum(spec, *ops):
    return jnp.einsum(spec, *ops, precision=_PRECISION)


def matmul(a, b) -> Jet:
    """Product-rule matmul (the reference's hot TensorMatDual::einsum role)."""
    if _is_jet(a) and _is_jet(b):
        r = jnp.matmul(a.r, b.r, precision=_PRECISION)
        d = _einsum("n...ij,...jk->n...ik", a.d, b.r) + _einsum(
            "...ij,n...jk->n...ik", a.r, b.d
        )
        return Jet(r, d)
    if _is_jet(a):
        return Jet(jnp.matmul(a.r, b, precision=_PRECISION),
                   _einsum("n...ij,...jk->n...ik", a.d, b))
    return Jet(jnp.matmul(a, b.r, precision=_PRECISION),
               _einsum("...ij,n...jk->n...ik", a, b.d))


def einsum(spec: str, *operands) -> Jet:
    """Einsum with product-rule tangents (96 uses of TensorDual::einsum in the
    reference C++ — here one generic rule)."""
    jets = [i for i, o in enumerate(operands) if _is_jet(o)]
    if not jets:
        return _einsum(spec, *operands)
    rs = [o.r if _is_jet(o) else o for o in operands]
    r = _einsum(spec, *rs)
    ins, out = spec.split("->") if "->" in spec else (spec, None)
    in_specs = ins.split(",")
    if out is None:
        raise ValueError("jet einsum requires explicit '->' output spec")
    d = None
    for i in jets:
        ops = list(rs)
        ops[i] = operands[i].d
        sp = ",".join(
            ("z" + s) if k == i else s for k, s in enumerate(in_specs)
        ) + "->z" + out
        term = _einsum(sp, *ops)
        d = term if d is None else d + term
    return Jet(r, d)


def jet_sum(x: Jet, axis=None, keepdims=False) -> Jet:
    if axis is None:
        return Jet(jnp.sum(x.r, keepdims=keepdims),
                   jnp.sum(x.d, axis=tuple(range(1, x.d.ndim)), keepdims=keepdims))
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    daxes = tuple(a + 1 if a >= 0 else a for a in axes)
    return Jet(jnp.sum(x.r, axis=axes, keepdims=keepdims),
               jnp.sum(x.d, axis=daxes, keepdims=keepdims))


sum = jet_sum  # module-level alias mirroring jnp.sum


def max_dual(x: Jet, axis=-1, keepdims=False) -> Jet:
    """Max over an axis, tangents follow the argmax (reference TensorDual::max_dual)."""
    return _extremum(x, axis, keepdims, jnp.argmax)


def min_dual(x: Jet, axis=-1, keepdims=False) -> Jet:
    return _extremum(x, axis, keepdims, jnp.argmin)


def _extremum(x: Jet, axis, keepdims, argfn):
    idx = argfn(x.r, axis=axis, keepdims=True)
    r = jnp.take_along_axis(x.r, idx, axis=axis)
    daxis = axis + 1 if axis >= 0 else axis
    didx = jnp.broadcast_to(idx[None], (x.d.shape[0],) + idx.shape)
    d = jnp.take_along_axis(x.d, didx, axis=daxis)
    if not keepdims:
        r = jnp.squeeze(r, axis=axis)
        d = jnp.squeeze(d, axis=daxis)
    return Jet(r, d)


def maximum(a, b) -> Jet:
    n = (a if _is_jet(a) else b).d.shape[0]
    a = _as_jet(a, n)
    b = _as_jet(b, n)
    return where(a.r >= b.r, a, b)


def minimum(a, b) -> Jet:
    n = (a if _is_jet(a) else b).d.shape[0]
    a = _as_jet(a, n)
    b = _as_jet(b, n)
    return where(a.r <= b.r, a, b)
