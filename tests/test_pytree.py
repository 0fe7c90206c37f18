"""The in-repo pytree dataclass (janus_tpu.pytree) behind Options and the
solver states: static fields are tree structure, the rest are leaves."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

from janus_tpu import pytree
from janus_tpu.solve import Options


@pytree.dataclass
class _Pair:
    x: jnp.ndarray
    scale: float = 1.0
    n: int = pytree.field(static=True, default=3)


def test_static_fields_are_not_leaves():
    leaves = jax.tree_util.tree_leaves(_Pair(jnp.ones(2), 2.0, n=5))
    assert len(leaves) == 2                    # x and scale; n is aux data
    names = {f.name for f in dataclasses.fields(Options)
             if f.metadata.get("static")}
    assert {"max_steps", "min_stages", "pallas_lu", "stage_solver"} <= names
    assert len(jax.tree_util.tree_leaves(Options())) == \
        len(dataclasses.fields(Options)) - len(names)


def test_static_field_changes_treedef():
    a = jax.tree_util.tree_structure(_Pair(jnp.ones(2), n=3))
    b = jax.tree_util.tree_structure(_Pair(jnp.ones(2), n=4))
    assert a != b
    assert a == jax.tree_util.tree_structure(_Pair(jnp.zeros(2), 7.0, n=3))


def test_replace_and_frozen():
    p = _Pair(jnp.ones(2))
    q = p.replace(scale=5.0, n=9)
    assert (p.scale, p.n) == (1.0, 3)
    assert (q.scale, q.n) == (5.0, 9)
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.scale = 2.0


def test_tree_map_round_trip():
    p = _Pair(jnp.arange(3.0), 2.0, n=6)
    q = jax.tree_util.tree_map(lambda v: v * 2, p)
    assert isinstance(q, _Pair) and q.n == 6 and q.scale == 4.0
    assert jnp.array_equal(q.x, jnp.arange(3.0) * 2)


def test_float_option_change_does_not_recompile():
    traces = []

    @jax.jit
    def f(opts, y):
        traces.append(1)
        return y * opts.rtol + opts.atol

    y = jnp.ones(3)
    f(Options(rtol=1e-6), y)
    f(Options(rtol=1e-7, atol=1e-12), y)
    assert len(traces) == 1                    # float leaves: same program
    f(Options(rtol=1e-7, max_stages=5), y)
    assert len(traces) == 2                    # static field: new program
