"""Checkpoints for the NN-training workflows: one ``.npz`` per step.

The reference has no checkpoint/resume at all (SURVEY §5) — its closest
artifact is a CSV dataset round-trip. A checkpoint here is a directory of
``step_<N>.npz`` files, each holding the pytree's leaves (``leaf_<i>``) and
its pickled treedef, so training scripts stay one-liner simple.
"""

from __future__ import annotations

import os
import pickle
import re
from pathlib import Path
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

_STEP_FILE = re.compile(r"step_(\d+)\.npz$")


def _steps(path: Path) -> list[int]:
    return sorted(int(m.group(1)) for f in path.glob("step_*.npz")
                  if (m := _STEP_FILE.match(f.name)))


def save_checkpoint(path, pytree: Any, step: int = 0) -> None:
    """Write ``pytree`` as ``<path>/step_<step>.npz`` (atomically)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    leaves, treedef = jax.tree_util.tree_flatten(pytree)
    arrays = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    arrays["treedef"] = np.frombuffer(pickle.dumps(treedef), np.uint8)
    tmp = path / f".step_{step}.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
    os.replace(tmp, path / f"step_{step}.npz")


def restore_checkpoint(path, template: Any = None, step: int | None = None):
    """Read a checkpoint back (the latest step unless ``step`` is given).

    With ``template`` the leaves are put into its structure and dtypes;
    without one, into the structure that was saved.
    """
    path = Path(path)
    if step is None:
        steps = _steps(path)
        if not steps:
            raise FileNotFoundError(f"no checkpoint under {path}")
        step = steps[-1]
    with np.load(path / f"step_{step}.npz", allow_pickle=False) as data:
        treedef = pickle.loads(data["treedef"].tobytes())
        leaves = [data[f"leaf_{i}"] for i in range(treedef.num_leaves)]
    if template is None:
        return jax.tree_util.tree_unflatten(
            treedef, [jnp.asarray(x) for x in leaves])
    t_leaves, t_def = jax.tree_util.tree_flatten(template)
    if t_def.num_leaves != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template "
                         f"{t_def.num_leaves}")
    return jax.tree_util.tree_unflatten(
        t_def, [jnp.asarray(x, dtype=jnp.asarray(t).dtype)
                for x, t in zip(leaves, t_leaves)])
