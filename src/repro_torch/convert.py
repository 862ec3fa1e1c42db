"""Carry parameter trees between the JAX package and the port.

Both directions go through numpy, so neither package imports the other:
``params_from_jax`` takes the numpy leaves of a JAX tree (for instance
``jax.tree_util.tree_map(np.asarray, params)``) and ``params_to_numpy``
gives them back with dict keys in ``jax.tree_util`` order (sorted). Trees
are nested dicts, lists and tuples (the decoder's ``segments`` is a list
of dicts). A bfloat16 leaf crosses as its 16-bit pattern: numpy's
``bfloat16`` (from ``ml_dtypes``) has no torch counterpart to convert
through, so the bits are carried and re-viewed on the other side.

``trainer_state_to_checkpoint`` and ``trainer_state_from_checkpoint`` do
the same for a round checkpoint of the trainer (``checkpoint.io``), whose
file holds the JAX trainer's dtypes: its (2,) uint32 key is the port's
int64 key words (``prng.PRNGKey``), and its uint32 secagg streams (the
ring's ``ring_y``, an async payload's ``y``) are the port's int32 word
storage. Leaves go in ``jax.tree_util`` order on both sides (dict keys
sorted, a NamedTuple's fields in order), which is how the optimizer slots,
the ring and the async buffer lists line up; bfloat16 leaves travel as
their 16-bit patterns. So a checkpoint written by either trainer resumes
in the port.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.nn.pytree import tree_leaves, tree_map, tree_unflatten


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


def _checkpoint_leaf(x: torch.Tensor):
    """A trainer-state tensor as the JAX trainer's checkpoint holds it:
    int64 key words and int32 word storage as uint32, the rest as is."""
    if x.dtype == torch.int64:
        a = x.detach().cpu().numpy()
        if ((a < 0) | (a > 0xFFFFFFFF)).any():
            raise ValueError("an int64 trainer leaf holds no u32 words")
        return a.astype(np.uint32)
    if x.dtype == torch.int32:
        return x.detach().cpu().numpy().view(np.uint32)
    return x


def trainer_state_to_checkpoint(tree):
    """The trainer's resume tree (tensors) -> the leaves a round
    checkpoint stores, in the JAX trainer's dtypes."""
    return tree_map(_checkpoint_leaf, tree)


def trainer_state_from_checkpoint(leaves: list, like):
    """A round checkpoint's leaves ((dtype name, numpy array) in file
    order, ``checkpoint.io.read_leaves``) -> the port trainer's resume
    tree in the structure, dtypes and devices of ``like``. Each leaf's
    shape must match; its dtype must match or be the JAX trainer's uint32
    form of an int64 key or an int32 word store."""
    from repro_torch.checkpoint.io import dtype_name, leaf_tensor
    tmpl = tree_leaves(like)
    if len(tmpl) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, the trainer's "
                         f"state has {len(tmpl)}")
    out = []
    for t, (name, arr) in zip(tmpl, leaves):
        want = dtype_name(t)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"leaf mismatch: ckpt {tuple(arr.shape)}/{name} "
                             f"vs trainer {tuple(t.shape)}/{want}")
        if name == "uint32" and t.dtype == torch.int64:
            x = torch.from_numpy(arr.astype(np.int64))
        elif name == "uint32" and t.dtype == torch.int32:
            x = torch.from_numpy(arr.view(np.int32).copy())
        elif name == want:
            x = leaf_tensor(name, arr)
        else:
            raise ValueError(f"leaf mismatch: ckpt {tuple(arr.shape)}/{name} "
                             f"vs trainer {tuple(t.shape)}/{want}")
        out.append(x.to(t.device))
    return tree_unflatten(like, out)
