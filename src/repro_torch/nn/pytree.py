"""Small tree utilities over the port's parameter containers.

Parameters and optimizer slots are nested dicts, tuples and NamedTuples
of tensors. Leaves are visited in ``jax.tree_util`` order (dict keys
sorted), so a flat view of a port tree lines up with the JAX package's.
"""
from __future__ import annotations

import torch


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leafwise over trees of identical structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *[r[k] for r in rest]) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*[tree_map(fn, *xs) for xs in zip(tree, *rest)])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves in ``jax.tree_util`` flatten order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_unflatten(like, leaves: list):
    """A tree of ``like``'s structure whose leaves are ``leaves``, taken in
    ``tree_leaves`` order (dicts keep ``like``'s key order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}
        if _is_namedtuple(t):
            return type(t)(*[build(x) for x in t])
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_weighted_sum(trees: list, weights: list):
    """sum_i weights[i] * trees[i], accumulated in fp32 in list order,
    cast back to each leaf's dtype."""
    if len(trees) != len(weights) or not trees:
        raise ValueError("tree_weighted_sum needs one weight per tree")

    def _wsum(*leaves):
        acc = leaves[0].to(torch.float32) * weights[0]
        for leaf, w in zip(leaves[1:], weights[1:]):
            acc = acc + leaf.to(torch.float32) * w
        return acc.to(leaves[0].dtype)

    return tree_map(_wsum, *trees)
