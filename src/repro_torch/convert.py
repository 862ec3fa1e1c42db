"""Carry parameter trees between the JAX package and the port.

Both directions go through numpy, so neither package imports the other:
``params_from_jax`` takes the numpy leaves of a JAX tree (for instance
``jax.tree_util.tree_map(np.asarray, params)``) and ``params_to_numpy``
gives them back with dict keys in ``jax.tree_util`` order (sorted).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.pytree import tree_map


def params_from_jax(tree, device=None):
    """Tree of numpy arrays -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)).to(dev), tree)


def params_to_numpy(tree):
    """Tree of tensors -> tree of numpy arrays, dict keys sorted."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(tree[k]) for k in sorted(tree)}
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
