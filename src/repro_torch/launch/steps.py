"""Step builders and abstract input specs (port of ``repro.launch.steps``).

The train, prefill and decode steps the launchers run, and the shapes of a
model's parameters, cache and inputs without allocating them: the JAX
package evaluates them with ``jax.eval_shape`` into
``ShapeDtypeStruct``s; the port builds the same trees as tensors on
``torch.device("meta")``, which carry a shape and a dtype and no storage.

``build_bundle`` wraps each (arch, shape) step with those abstract
arguments and their sharding specs (``sharding.specs``) in a
``StepBundle``, which the dry-run places as DTensors on the production
mesh. Under a mesh ``ctx`` the steps run on DTensors (plain tensors made
inside a step count as replicated, ``sharding.context.mesh_scope``); with
``ctx=None`` they are the plain one-device functions.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import prng
from repro_torch.configs.shapes import InputShape, cfg_for_shape, shape_for
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import ModelApi, get_config, get_model
from repro_torch.nn.optim import (OptState, Optimizer, get_optimizer,
                                  inv_sqrt_schedule)
from repro_torch.nn.pytree import tree_leaves, tree_unflatten
from repro_torch.sharding.context import DistCtx, is_dtensor, mesh_scope
from repro_torch.sharding.specs import (P, batch_specs, cache_specs,
                                        param_specs)

_META = torch.device("meta")


class StepBundle(NamedTuple):
    """Everything needed to trace one (arch × shape) combination."""
    cfg: ArchConfig
    api: ModelApi
    step_fn: Any            # the step function
    arg_shapes: tuple       # meta-tensor trees (positional)
    in_specs: tuple         # spec trees matching arg_shapes
    out_specs: Any          # spec trees of the outputs (or None = auto)
    mode: str


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
        loss, grads = loss_and_grads(cfg, api, params, batch, ctx)
        with mesh_scope(ctx):
            params, opt_state = optimizer.update(grads, opt_state, params,
                                                 stepno)
        return params, opt_state, loss
    return train_step


def loss_and_grads(cfg: ArchConfig, api: ModelApi, params, batch, ctx=None):
    """(loss, grads): ``api.loss`` (detached) and its gradient by every
    parameter. Under a mesh each gradient comes back placed as its
    parameter: a sum of the ranks' shares (a weight replicated where the
    work is split) is reduced here, so every rank applies one update."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad(), mesh_scope(ctx):
        loss = api.loss(cfg, tree_unflatten(params, leaves), batch, ctx)
        grads = torch.autograd.grad(loss, leaves)
    grads = [g.redistribute(p.device_mesh, p.placements)
             if is_dtensor(g) and g.placements != p.placements else g
             for g, p in zip(grads, leaves)]
    return loss.detach(), tree_unflatten(params, grads)


def make_prefill_step(cfg: ArchConfig, api: ModelApi, ctx=None):
    """(params, {"tokens": (B, S)}, plus "audio_embeds" or "image_embeds"
    for encdec and vlm) -> next-token logits (B, Vp): the last position of
    ``api.forward``, with the LM head applied to that position only (XLA
    pushes the JAX package's slice through the matmul; eager torch would
    compute every position's logits)."""
    def prefill_step(params, batch):
        with mesh_scope(ctx):
            return api.prefill(cfg, params, batch, ctx)
    return prefill_step


def make_decode_step(cfg: ArchConfig, api: ModelApi, ctx=None):
    """(params, cache, {"token": (B,), "pos": (B,)}) -> (logits, cache)."""
    def decode_step(params, cache, batch):
        with mesh_scope(ctx):
            return api.decode_step(cfg, params, cache, batch, ctx)
    return decode_step


def build_bundle(arch: str, shape_name: str, ctx: DistCtx,
                 optimizer: str = "sgd", kv_int8: bool = False) -> StepBundle:
    shape = shape_for(shape_name)
    cfg = cfg_for_shape(get_config(arch), shape_name)
    if kv_int8:
        cfg = cfg.replace(kv_cache_dtype="int8")
    api = get_model(cfg)
    p_abs = abstract_params(cfg, api)
    p_spec = param_specs(cfg, p_abs, ctx)
    batch = input_specs(cfg, shape)
    b_spec = batch_specs(cfg, batch, ctx)

    if shape.mode == "train":
        opt = _opt_for(cfg, optimizer)
        o_abs = opt.init(p_abs)
        o_spec = _opt_specs(o_abs, p_spec)
        step = make_train_step(cfg, api, opt, ctx)
        stepno = torch.empty((), dtype=torch.int32, device=_META)
        return StepBundle(cfg, api, step,
                          (p_abs, o_abs, batch, stepno),
                          (p_spec, o_spec, b_spec, P()),
                          (p_spec, o_spec, P()), "train")

    if shape.mode == "prefill":
        step = make_prefill_step(cfg, api, ctx)
        return StepBundle(cfg, api, step, (p_abs, batch), (p_spec, b_spec),
                          None, "prefill")

    # decode
    c_abs = abstract_cache(cfg, api, shape.global_batch, shape.seq_len)
    c_spec = cache_specs(cfg, c_abs, ctx)
    step = make_decode_step(cfg, api, ctx)
    return StepBundle(cfg, api, step, (p_abs, c_abs, batch),
                      (p_spec, c_spec, b_spec), (None, c_spec), "decode")


def _opt_specs(o_abs, p_spec):
    """Optimizer moments shard like their parameters."""
    slots = o_abs.slots
    if isinstance(slots, dict) and set(slots) == {"m", "v"}:
        return OptState(slots={"m": p_spec, "v": p_spec})   # adamw
    if tree_leaves(slots):
        return OptState(slots=p_spec)                        # momentum
    return OptState(slots=slots)                             # sgd: empty
