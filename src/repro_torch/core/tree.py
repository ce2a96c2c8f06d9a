"""The port's two walkers over its trees (params, optimizer state, caches,
layouts): nested dicts whose leaves are anything but a dict.

:func:`leaves` walks in insertion order; :func:`flatten` in sorted key
order at every level, with "/"-joined paths, which is the order and the
key form of ``jax.tree_util`` over the reference's trees (the checkpoint
format's keys, the optimizer's leaf order, the sharding rules' paths).
"""

from __future__ import annotations

from typing import Any


def leaves(tree: dict):
    """The leaves of ``tree``, in insertion order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from leaves(v)
        else:
            yield v


def flatten(tree: dict, prefix: str = "") -> dict[str, Any]:
    """{"a/b/c": leaf}, sorted keys at each level."""
    flat = {}
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            flat.update(flatten(tree[key], path + "/"))
        else:
            flat[path] = tree[key]
    return flat


def unflatten(flat: dict[str, Any]) -> dict:
    """{"a/b/c": leaf} -> nested dicts (the inverse of :func:`flatten`)."""
    tree: dict = {}
    for key, leaf in flat.items():
        node = tree
        *parents, name = key.split("/")
        for parent in parents:
            node = node.setdefault(parent, {})
        node[name] = leaf
    return tree
