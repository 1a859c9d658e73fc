"""Small pytree + PRNG utilities shared across samplers."""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp


def pytree_dataclass(cls):
    """Frozen dataclass registered as a pytree, with ``.replace(**changes)``.

    Fields are pytree children unless declared with :func:`static_field`,
    which makes them part of the treedef (hashable metadata).
    """
    cls = dataclasses.dataclass(frozen=True)(cls)
    fields = dataclasses.fields(cls)
    jax.tree_util.register_dataclass(
        cls,
        data_fields=[f.name for f in fields if not f.metadata.get("static")],
        meta_fields=[f.name for f in fields if f.metadata.get("static")])
    cls.replace = lambda self, **changes: dataclasses.replace(self, **changes)
    return cls


def static_field(**kwargs):
    """A :func:`pytree_dataclass` field kept out of the pytree's leaves."""
    return dataclasses.field(metadata={"static": True}, **kwargs)


def tree_random_normal(key, example: Any) -> Any:
    """Standard-normal pytree with the shapes/dtypes of ``example``."""
    leaves, treedef = jax.tree.flatten(example)
    keys = jax.random.split(key, len(leaves))
    return treedef.unflatten(
        [jax.random.normal(k, l.shape, l.dtype) for k, l in zip(keys, leaves)]
    )


def tree_where(pred, a: Any, b: Any) -> Any:
    """Elementwise select whole pytrees on a scalar (or broadcastable) pred."""
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def tree_add(a: Any, b: Any) -> Any:
    return jax.tree.map(jnp.add, a, b)


def tree_sub(a: Any, b: Any) -> Any:
    return jax.tree.map(jnp.subtract, a, b)


def tree_mul(a: Any, b: Any) -> Any:
    return jax.tree.map(jnp.multiply, a, b)


def tree_scale(c, a: Any) -> Any:
    return jax.tree.map(lambda x: c * x, a)


def tree_axpy(c, x: Any, y: Any) -> Any:
    """y + c * x."""
    return jax.tree.map(lambda xi, yi: yi + c * xi, x, y)


def tree_dot(a: Any, b: Any) -> jnp.ndarray:
    parts = jax.tree.map(lambda x, y: jnp.sum(x * y), a, b)
    return sum(jax.tree.leaves(parts), start=jnp.asarray(0.0, jnp.float32))


def tree_size(a: Any) -> int:
    return sum(int(x.size) for x in jax.tree.leaves(a))
