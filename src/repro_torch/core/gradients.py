"""Local-training gradient rule (port of ``repro.core.gradients``).

``fl.grad_method='autodiff'`` is exact reverse mode through the simulator
and the fused gate-layer op. With a leading client axis the model's loss
is one value per client; one backward of their SUM gives every client its
own gradient, because no client's loss depends on another client's
parameters. ``'param_shift'`` is not ported yet (ROADMAP queue 1, item 9).
"""
from __future__ import annotations

import torch


def make_grad_fn(api, model_cfg, fl):
    """(params, batch) -> (loss, grads) under fl.grad_method.

    The loss comes back detached, with the shape the model's loss has
    (one value per client under a client axis); grads match ``params``.
    """
    if fl.grad_method == "param_shift":
        raise NotImplementedError(
            "grad_method='param_shift' is not ported yet (ROADMAP queue 1, "
            "item 9: teleport + parameter-shift)")
    if fl.grad_method != "autodiff":
        raise ValueError(f"unknown grad_method {fl.grad_method!r}")

    def grad_fn(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = api.loss(model_cfg, leaves, batch)
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    return grad_fn
