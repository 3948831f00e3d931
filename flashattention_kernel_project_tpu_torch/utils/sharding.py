"""Partition specs: how an array is laid out over a device mesh.

The port's counterpart of jax.sharding.PartitionSpec, kept small: `P(...)`
is a tuple with one entry per dimension of the array, a mesh axis name
(that dimension is cut into equal blocks, one per position along the axis)
or None (the dimension is whole on every rank). A spec shorter than the
array leaves its trailing dimensions whole, and `P()` is a replicated
array. parallel.shard_params takes a tree of these.
"""

from __future__ import annotations


class P(tuple):
    """A partition spec: P(None, "model", None) cuts dimension 1 over the
    mesh's "model" axis."""

    def __new__(cls, *axes):
        for a in axes:
            if a is not None and not isinstance(a, str):
                raise TypeError(f"a spec entry is an axis name or None, got {a!r}")
        return super().__new__(cls, axes)

    def __reduce__(self):
        # pickle rebuilds it from its entries (a spawned rank's specs)
        return type(self), tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(map(repr, self)) + ")"
