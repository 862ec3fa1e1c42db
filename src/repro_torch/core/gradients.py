"""Local-training gradient rule (port of ``repro.core.gradients``).

``fl.grad_method`` selects how a satellite computes its local update:

  autodiff     — exact reverse mode through the model and its kernels'
                 ``autograd.Function``s.
  param_shift  — the hardware-faithful ±π/2 parameter-shift rule (what a
                 real QPU evaluates; Qiskit QNN's gradient). The model's
                 ModelApi must expose ``shift_grad``: the VQC's rule takes
                 the client axis as it is.

Both take params and batch with a leading client axis (the JAX package
vmaps the rule over it) and return ``(loss, grads)``: the losses (K,)
detached, and grads with the params' tree structure.

**The client axis.** A model whose ModelApi sets ``client_axis_loss``
(the VQC) takes the axis in its loss and returns one value per client,
so one backward of their SUM gives every client its own gradient: no
client's loss depends on another client's parameters. A decoder's loss
is one model's, so for every other model each row's loss and gradient
are taken in a Python loop and stacked: what ``jax.vmap`` of the JAX
rule computes. ``torch.func.vmap`` cannot batch
the kernels' ``autograd.Function``s, which launch through ctypes.
Parameter trees may nest (a decoder's ``"segments"`` list); they are
walked with ``nn.pytree``.
"""
from __future__ import annotations

import torch

from repro_torch.nn.pytree import tree_leaves, tree_map, tree_unflatten


def _value_and_grad(api, model_cfg, params, batch):
    """(loss, grads) of ``api.loss``, the gradient of the loss's sum."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with torch.enable_grad():
        loss = api.loss(model_cfg, tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss.sum(), leaves)
    return loss.detach(), tree_unflatten(params, list(grads))


def make_grad_fn(api, model_cfg, fl):
    """(params, batch) -> (loss, grads) under fl.grad_method, both with a
    leading client axis (see the module doc)."""
    if fl.grad_method == "param_shift":
        if api.shift_grad is None:
            raise ValueError(
                "grad_method='param_shift' needs ModelApi.shift_grad — "
                "only quantum models define a parameter-shift rule")
        # the shift rule's base sweep already evaluates the batch: it
        # reports the loss itself rather than paying a second forward
        return lambda p, batch: api.shift_grad(
            model_cfg, p, batch, chunk=fl.shift_chunk, with_loss=True)
    if fl.grad_method != "autodiff":
        raise ValueError(f"unknown grad_method {fl.grad_method!r}")
    if api.client_axis_loss:
        return lambda p, batch: _value_and_grad(api, model_cfg, p, batch)

    def grad_fn(params, batch):
        rows = [_value_and_grad(api, model_cfg,
                                tree_map(lambda a: a[k], params),
                                tree_map(lambda a: a[k], batch))
                for k in range(tree_leaves(params)[0].shape[0])]
        losses = torch.stack([loss for loss, _ in rows])
        return losses, tree_map(lambda *g: torch.stack(g),
                                *[g for _, g in rows])

    return grad_fn
