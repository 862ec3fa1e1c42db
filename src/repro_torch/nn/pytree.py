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


def tree_stack(trees: list):
    """Trees of one structure -> one tree, each leaf the stack of theirs
    along a new leading axis (a layer axis)."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def tree_size(tree) -> int:
    """Total number of scalar elements."""
    return sum(x.numel() for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


def tree_flatten_to_vector(tree, dtype=torch.float32) -> torch.Tensor:
    """All leaves cast to ``dtype`` and concatenated into one 1-D vector."""
    return torch.cat([x.to(dtype).reshape(-1) for x in tree_leaves(tree)])


def tree_unflatten_from_vector(vec: torch.Tensor, like):
    """Inverse of ``tree_flatten_to_vector`` given a template: each leaf
    takes its slice of ``vec``, reshaped and cast to the template's."""
    out, off = [], 0
    for leaf in tree_leaves(like):
        n = leaf.numel()
        out.append(vec[off:off + n].reshape(leaf.shape).to(leaf.dtype))
        off += n
    return tree_unflatten(like, out)


def tree_cast(tree, dtype):
    return tree_map(lambda x: x.to(dtype), tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_scale(tree, s):
    """Every leaf times ``s``, in float32, cast back to the leaf's dtype."""
    return tree_map(lambda x: (x.to(torch.float32) * s).to(x.dtype), tree)


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
