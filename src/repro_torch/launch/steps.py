"""Step builders and abstract input specs (port of ``repro.launch.steps``).

The train, prefill and decode steps the launchers run, and the shapes of a
model's parameters, cache and inputs without allocating them: the JAX
package evaluates them with ``jax.eval_shape`` into
``ShapeDtypeStruct``s; the port builds the same trees as tensors on
``torch.device("meta")``, which carry a shape and a dtype and no storage.

The JAX package also wraps each (arch, shape) step in a ``StepBundle``
with its sharding specs (``build_bundle``) for its multi-device dry-run.
Those specs come from ``sharding/specs.py``, which the port does not have
yet, so ``StepBundle`` and ``build_bundle`` wait for ROADMAP queue 1,
item 12b; the port runs on one card and returns the plain functions.
``ctx`` is accepted and ignored.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.configs.shapes import InputShape
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import ModelApi
from repro_torch.nn.optim import Optimizer, get_optimizer, inv_sqrt_schedule
from repro_torch.nn.pytree import tree_leaves, tree_unflatten

_META = torch.device("meta")


def abstract_params(cfg: ArchConfig, api: ModelApi):
    """The parameter tree of ``api.init(cfg, PRNGKey(0))`` as meta tensors."""
    return api.init(cfg, prng.PRNGKey(0, _META))


def abstract_cache(cfg: ArchConfig, api: ModelApi, batch: int,
                   cache_len: int):
    """The serving cache of ``api.init_cache`` as meta tensors."""
    return api.init_cache(cfg, batch, cache_len, device=_META)


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict:
    """Meta-tensor stand-ins for the model inputs of this shape."""
    B, S = shape.global_batch, shape.seq_len
    spec = lambda dims, dtype=torch.int32: torch.empty(dims, dtype=dtype,
                                                       device=_META)
    if shape.mode in ("train", "prefill"):
        batch = {"tokens": spec((B, S))}
        if shape.mode == "train":
            batch["labels"] = spec((B, S))
        if cfg.family == "encdec":
            batch["audio_embeds"] = spec((B, cfg.n_audio_frames, cfg.d_model),
                                         getattr(torch, cfg.dtype))
        if cfg.family == "vlm":
            batch["image_embeds"] = spec((B, cfg.n_image_tokens, cfg.d_model),
                                         getattr(torch, cfg.dtype))
        return batch
    # decode: ONE new token against a seq_len cache
    return {"token": spec((B,)), "pos": spec((B,))}


def stub_embeds(cfg: ArchConfig, batch: int, audio_key, image_key) -> dict:
    """The JAX launchers' stand-in for the stubbed frontends: 0.02 times a
    float32 standard normal draw, audio frames (encdec) under
    ``audio_key`` or image tokens (vlm) under ``image_key``; nothing for
    the other families."""
    if cfg.family == "encdec":
        return {"audio_embeds": 0.02 * prng.normal(
            audio_key, (batch, cfg.n_audio_frames, cfg.d_model))}
    if cfg.family == "vlm":
        return {"image_embeds": 0.02 * prng.normal(
            image_key, (batch, cfg.n_image_tokens, cfg.d_model))}
    return {}


def _opt_for(cfg: ArchConfig, name: str = "sgd") -> Optimizer:
    return get_optimizer(name, inv_sqrt_schedule(1e-2))


def make_train_step(cfg: ArchConfig, api: ModelApi, optimizer: Optimizer,
                    ctx=None):
    """(params, opt_state, batch, stepno) -> (params, opt_state, loss): one
    backward of ``api.loss`` and one optimizer update. The given params
    and slots are not written; the loss comes back detached."""
    def train_step(params, opt_state, batch, stepno):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            loss = api.loss(cfg, tree_unflatten(params, leaves), batch, ctx)
            grads = torch.autograd.grad(loss, leaves)
        params, opt_state = optimizer.update(
            tree_unflatten(params, list(grads)), opt_state, params, stepno)
        return params, opt_state, loss.detach()
    return train_step


def make_prefill_step(cfg: ArchConfig, api: ModelApi, ctx=None):
    """(params, {"tokens": (B, S)}, plus "audio_embeds" or "image_embeds"
    for encdec and vlm) -> next-token logits (B, Vp): the last position of
    ``api.forward``, with the LM head applied to that position only (XLA
    pushes the JAX package's slice through the matmul; eager torch would
    compute every position's logits)."""
    def prefill_step(params, batch):
        return api.prefill(cfg, params, batch, ctx)
    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelApi, ctx=None):
    """(params, cache, {"token": (B,), "pos": (B,)}) -> (logits, cache)."""
    def decode_step(params, cache, batch):
        return api.decode_step(cfg, params, cache, batch, ctx)
    return decode_step
