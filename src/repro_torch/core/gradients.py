"""Local-training gradient rule (port of ``repro.core.gradients``).

``fl.grad_method`` selects how a satellite computes its local update:

  autodiff     — exact reverse mode through the simulator and the fused
                 gate-layer op. With a leading client axis the model's loss
                 is one value per client; one backward of their SUM gives
                 every client its own gradient, because no client's loss
                 depends on another client's parameters.
  param_shift  — the hardware-faithful ±π/2 parameter-shift rule (what a
                 real QPU evaluates; Qiskit QNN's gradient). The model's
                 ModelApi must expose ``shift_grad``: the VQC's rule takes
                 the client axis as it is.

Both return ``(loss, grads)`` with identical tree structure, so the
optimizer update is untouched by the choice.
"""
from __future__ import annotations

import torch


def make_grad_fn(api, model_cfg, fl):
    """(params, batch) -> (loss, grads) under fl.grad_method.

    The loss comes back detached, with the shape the model's loss has
    (one value per client under a client axis); grads match ``params``.
    """
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

    def grad_fn(params, batch):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = api.loss(model_cfg, leaves, batch)
            grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
        return loss.detach(), dict(zip(leaves, grads))

    return grad_fn
