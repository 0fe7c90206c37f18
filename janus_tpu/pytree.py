"""Frozen dataclasses registered as JAX pytrees.

``@dataclass`` makes a frozen dataclass whose fields are pytree leaves,
except those declared with ``field(static=True)``: those are static aux data,
part of the tree structure (a change of one recompiles a jitted caller; a
change of a leaf does not). ``.replace(**changes)`` returns a copy.
"""

from __future__ import annotations

import dataclasses

import jax


def field(*, static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    return dataclasses.field(metadata={"static": static}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    """Frozen dataclass + ``jax.tree_util.register_dataclass``."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    meta = [f.name for f in fields if f.metadata.get("static", False)]
    data = [f.name for f in fields if not f.metadata.get("static", False)]
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls, data_fields=data,
                                            meta_fields=meta)
