"""npz checkpoints (janus_tpu.utils.checkpoint): round trip, latest step,
template structure and dtypes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from janus_tpu.models.neural import mlp_init
from janus_tpu.utils import restore_checkpoint, save_checkpoint


def _params():
    return mlp_init(jax.random.PRNGKey(0), [2, 8, 1], jnp.float32)


def test_round_trip_without_template(tmp_path):
    p = {"net": _params(), "step": jnp.asarray(7), "lr": (1e-3,)}
    save_checkpoint(tmp_path, p, step=4)
    q = restore_checkpoint(tmp_path)
    assert jax.tree_util.tree_structure(q) == jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(p),
                    jax.tree_util.tree_leaves(q)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_latest_step_and_explicit_step(tmp_path):
    p = _params()
    for step in (3, 12, 7):
        save_checkpoint(tmp_path, jax.tree_util.tree_map(
            lambda x, s=step: x + s, p), step=step)
    latest = restore_checkpoint(tmp_path, template=p)
    np.testing.assert_allclose(latest["w"][0], p["w"][0] + 12)
    third = restore_checkpoint(tmp_path, template=p, step=3)
    np.testing.assert_allclose(third["w"][0], p["w"][0] + 3)


def test_template_sets_structure_and_dtype(tmp_path):
    p = _params()
    save_checkpoint(tmp_path, jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64), p))
    q = restore_checkpoint(tmp_path, template=p)
    assert all(x.dtype == jnp.float32 for x in jax.tree_util.tree_leaves(q))
    with pytest.raises(ValueError):
        restore_checkpoint(tmp_path, template={"w": p["w"]})


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(tmp_path / "none")
