"""Llama-3.2-Vision-style VLM backbone (port of ``repro.models.vlm``).

The ViT/SigLIP vision encoder + projector is stubbed, as in the JAX
package: ``batch["image_embeds"]`` supplies projected image-token
embeddings of shape (B, n_image_tokens, d_model). This module is the
language decoder: llama self-attention layers interleaved with tanh-gated
cross-attention layers, one every ``cross_every`` layers (zero-init
gates, as in Llama-3.2-Vision / Flamingo).

The network is L = n_groups * cross_every layers; each group is one
cross-attention layer and (cross_every - 1) self-attention layers. The
parameters stack as the JAX package's do, so ``convert.params_from_jax``
maps the trees leaf for leaf: ``groups.cross`` on (G,), ``groups.selfs``
on (G, S), and the self cache on (G, S, B, cache_len, KV, hd). The
forward loops over groups and layers in Python (the JAX package scans
them). On the card each self layer's causal attention runs kernel #6
(``kernels.swa_attention``) with rope; cross-attention is plain torch,
as in the JAX package. The image embeddings are cast to the model's
dtype on entry. Training gives each layer (a cross block or a self
block) one non-reentrant checkpoint; the JAX package checkpoints each
group, which recomputes the same layers. Under a mesh ``ctx`` the
carry is held sequence-sharded (``decoder._seq_constraint``) where the
JAX package constrains it: entering each group, entering each self
layer and leaving the group.
"""
from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.config import ArchConfig
from repro_torch.models.decoder import (
    _dtype, _layer, _logits, _remat, _seq_constraint, chunked_ce,
)
from repro_torch.nn.init import normal_init, scaled_init
from repro_torch.nn.pytree import tree_stack
from repro_torch.sharding.context import mesh_scope
from repro_torch.sharding.specs import whole_dim

_F32 = torch.float32


def _n_groups(cfg: ArchConfig) -> int:
    if cfg.n_layers % cfg.cross_every:
        raise ValueError(f"{cfg.n_layers} layers not divisible into groups "
                         f"of {cfg.cross_every}")
    return cfg.n_layers // cfg.cross_every


def _self_window(cfg: ArchConfig) -> int:
    return cfg.sliding_window


def init(cfg: ArchConfig, key) -> dict:
    """Random parameters on the key's device: the JAX package's from the
    same key (8 keys split, 6 used, in its order)."""
    dtype = _dtype(cfg)
    dev = key.device
    G = _n_groups(cfg)
    S = cfg.cross_every - 1               # self layers per group
    ks = prng.split(key, 8)
    ones = lambda *shape: torch.ones(shape, dtype=dtype, device=dev)
    zeros32 = lambda: torch.zeros((G,), dtype=_F32, device=dev)
    groups = {
        "cross": {
            "attn": B.attn_init(ks[0], cfg, G, dtype),
            "ln1": ones(G, cfg.d_model),
            "gate_attn": zeros32(),       # tanh gate, zero-init
            "ffn": B.ffn_init(ks[1], cfg, G, dtype),
            "ln2": ones(G, cfg.d_model),
            "gate_ffn": zeros32(),
        },
        "selfs": {
            "attn": B.attn_init(ks[2], cfg, (G, S), dtype),
            "ln1": ones(G, S, cfg.d_model),
            "ffn": B.ffn_init(ks[3], cfg, (G, S), dtype),
            "ln2": ones(G, S, cfg.d_model),
        },
    }
    return {
        "embed": normal_init(ks[4], (cfg.padded_vocab, cfg.d_model), dtype),
        "groups": groups,
        "final_norm": ones(cfg.d_model),
        "lm_head": scaled_init(ks[5], (cfg.d_model, cfg.padded_vocab), dtype),
    }


def _gate(g, x):
    """tanh of a float32 gate, in x's dtype."""
    return torch.tanh(g).to(x.dtype)


def _cross_block(cfg, gp, x, vision):
    h = B.rms_norm(x, gp["ln1"], cfg.norm_eps)
    x = x + _gate(gp["gate_attn"], x) * B.cross_attn_apply(gp["attn"], cfg,
                                                           h, vision)
    h = B.rms_norm(x, gp["ln2"], cfg.norm_eps)
    return x + _gate(gp["gate_ffn"], x) * B.ffn_apply(gp["ffn"], h)


def _self_block(cfg, lp, x, positions, window, ctx=None):
    h = B.rms_norm(x, lp["ln1"], cfg.norm_eps)
    x = x + B.attn_apply(lp["attn"], cfg, h, positions, window=window,
                         ctx=ctx)
    h = B.rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + B.ffn_apply(lp["ffn"], h)


def forward_hidden(cfg: ArchConfig, params, batch, ctx=None,
                   remat: bool = True):
    """batch: {"tokens": (B,S), "image_embeds": (B,T_img,d)} ->
    final-normed hidden states (B,S,d)."""
    with mesh_scope(ctx):
        return _forward_hidden(cfg, params, batch, ctx, remat)


def _forward_hidden(cfg: ArchConfig, params, batch, ctx, remat: bool):
    tokens = batch["tokens"]
    x = B.embed_lookup(params["embed"], tokens)
    vision = batch["image_embeds"].to(x.dtype)
    Bb, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device)[None].expand(Bb, S)
    win = _self_window(cfg)
    remat = remat and torch.is_grad_enabled()
    for g in range(_n_groups(cfg)):
        gp = _layer(params["groups"], g)
        x = _remat(lambda x, gp=gp: _cross_block(
            cfg, gp["cross"], _seq_constraint(x, ctx), vision), x, remat)
        for s in range(cfg.cross_every - 1):
            lp = _layer(gp["selfs"], s)
            x = _remat(lambda x, lp=lp: _self_block(
                cfg, lp, _seq_constraint(x, ctx), positions, win, ctx),
                x, remat)
        x = _seq_constraint(x, ctx)
    return B.rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(cfg: ArchConfig, params, batch, ctx=None, remat: bool = True):
    """Returns (logits (B,S,Vp), aux 0)."""
    x = forward_hidden(cfg, params, batch, ctx, remat)
    with mesh_scope(ctx):
        return _logits(cfg, params, x), torch.zeros((), dtype=_F32,
                                                    device=x.device)


def prefill(cfg: ArchConfig, params, batch, ctx=None):
    """Next-token logits (B,Vp) of ``forward``'s last position; the LM head
    runs on that position only."""
    x = forward_hidden(cfg, params, batch, ctx, remat=False)
    with mesh_scope(ctx):
        return _logits(cfg, params, whole_dim(x)[:, -1])


def loss(cfg: ArchConfig, params, batch, ctx=None):
    """Mean next-token cross-entropy of batch {"tokens", "image_embeds",
    "labels", optional "mask"}, the logits in chunks."""
    x = forward_hidden(cfg, params, batch, ctx)
    return chunked_ce(cfg, params, x, batch["labels"], batch.get("mask"),
                      ctx=ctx)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device=None) -> dict:
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    G = _n_groups(cfg)
    S = cfg.cross_every - 1
    win = _self_window(cfg)
    clen = min(win, cache_len) if win > 0 else cache_len
    return {
        "self": B.attn_cache_init(cfg, (G, S), batch, clen, dtype, dev),
        "cross": B.cross_attn_cache_init(cfg, G, batch, cfg.n_image_tokens,
                                         dtype, dev),
    }


def prefill_cross(cfg: ArchConfig, params, cache, image_embeds):
    """Fill every group's cross K/V cache from the image embeddings."""
    image_embeds = image_embeds.to(params["embed"].dtype)
    groups = [B.cross_attn_prefill_cache(
        _layer(params["groups"]["cross"]["attn"], g), cfg, image_embeds)
        for g in range(_n_groups(cfg))]
    return {"self": cache["self"],
            "cross": tree_stack(groups)}


def decode_step(cfg: ArchConfig, params, cache, batch, ctx=None):
    """batch: {"token": (B,), "pos": (B,)} -> (logits (B,Vp), new_cache);
    the cross K/V must be prefilled. The given cache is not written."""
    token, pos = batch["token"], batch["pos"]
    x = B.embed_lookup(params["embed"], token)[:, None, :]
    win = _self_window(cfg)
    new_self = []
    for g in range(_n_groups(cfg)):
        gp = _layer(params["groups"], g)
        cp = gp["cross"]
        h = B.rms_norm(x, cp["ln1"], cfg.norm_eps)
        a = B.cross_attn_decode(cp["attn"], cfg, h, _layer(cache["cross"], g))
        x = x + _gate(cp["gate_attn"], x) * a
        h = B.rms_norm(x, cp["ln2"], cfg.norm_eps)
        x = x + _gate(cp["gate_ffn"], x) * B.ffn_apply(cp["ffn"], h)
        self_c = _layer(cache["self"], g)
        layers = []
        for s in range(cfg.cross_every - 1):
            lp = _layer(gp["selfs"], s)
            h = B.rms_norm(x, lp["ln1"], cfg.norm_eps)
            y, nc = B.attn_decode(lp["attn"], cfg, h, pos,
                                  _layer(self_c, s), window=win)
            layers.append(nc)
            x = x + y
            h = B.rms_norm(x, lp["ln2"], cfg.norm_eps)
            x = x + B.ffn_apply(lp["ffn"], h)
        new_self.append(tree_stack(layers))
    x = B.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = _logits(cfg, params, x)[:, 0, :]
    return logits, {"self": tree_stack(new_self), "cross": cache["cross"]}
