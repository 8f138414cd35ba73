"""Nested dicts of tensors in the reference's leaf order.

``jax.tree.flatten`` of a dict visits its keys sorted, at every level,
depth first. The stochastic-rounding noise of the collective forms is
drawn leaf by leaf in that order, so the port flattens the same way.
"""
from __future__ import annotations

from typing import Any, Iterable, List


def flatten(tree) -> List[Any]:
    """The leaves of a nested dict, keys sorted at every level."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    return [tree]


def unflatten(like, leaves: Iterable[Any]):
    """A tree of ``like``'s structure (and key order) holding ``leaves``,
    given in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if not isinstance(t, dict):
            return next(it)
        out = {k: build(t[k]) for k in sorted(t)}
        return {k: out[k] for k in t}
    return build(like)
