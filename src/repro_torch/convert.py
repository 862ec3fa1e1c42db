"""Carry parameter trees between the JAX package and the port.

Both directions go through numpy, so neither package imports the other:
``params_from_jax`` takes the numpy leaves of a JAX tree (for instance
``jax.tree_util.tree_map(np.asarray, params)``) and ``params_to_numpy``
gives them back with dict keys in ``jax.tree_util`` order (sorted). Trees
are nested dicts, lists and tuples (the decoder's ``segments`` is a list
of dicts). A bfloat16 leaf crosses as its 16-bit pattern: numpy's
``bfloat16`` (from ``ml_dtypes``) has no torch counterpart to convert
through, so the bits are carried and re-viewed on the other side.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.pytree import tree_map


def _to_tensor(x) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.tensor(a)


def _to_numpy(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    if x.dtype == torch.bfloat16:
        import ml_dtypes             # numpy's bfloat16, as JAX gives it
        return x.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return x.numpy()


def params_from_jax(tree, device=None):
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: _to_tensor(x).to(dev), tree)


def params_to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays, dict keys sorted."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(params_to_numpy(t) for t in tree)
    return tree_map(_to_numpy, tree)
