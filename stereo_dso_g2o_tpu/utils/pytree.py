"""Frozen dataclasses registered as JAX pytrees.

`@dataclass` makes a frozen `dataclasses.dataclass` whose fields are pytree
leaves, except those declared with `static_field()`, which become static aux
data (part of the jit cache key). Instances get a `.replace(**changes)`
method that returns a copy with the given fields changed.
"""

from __future__ import annotations

import dataclasses

import jax


def static_field(**kwargs):
    """A dataclass field held as static pytree metadata, not as a leaf."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def _replace(self, **changes):
    return dataclasses.replace(self, **changes)


def dataclass(cls):
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = _replace
    return jax.tree_util.register_dataclass(cls)
