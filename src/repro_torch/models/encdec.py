"""Whisper-style encoder-decoder, the audio family (port of ``repro.models.encdec``).

The mel-spectrogram + conv feature extractor is stubbed, as in the JAX
package: ``batch["audio_embeds"]`` supplies precomputed frame embeddings
of shape (B, n_audio_frames, d_model). This module is the transformer
backbone: a non-causal encoder over frames and a causal decoder with
cross-attention, pre-LN LayerNorm and GELU MLPs with biases, the
decoder's positions learned and its unembedding tied.

On the card the decoder's causal self-attention runs kernel #6
(``kernels.swa_attention``) at W=0 without rope; the encoder's
non-causal attention and every cross-attention are plain torch, as the
JAX package computes them. The embeddings are cast to the model's dtype
on entry (the JAX package lets a float32 embedding promote a bfloat16
model's encoder to float32; torch's matmul takes one dtype). Training
gives each layer one non-reentrant checkpoint, as ``decoder.loss`` does.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.config import ArchConfig
from repro_torch.models.decoder import (
    _dtype, _layer, _logits, _remat, chunked_ce,
)
from repro_torch.nn.common import layer_norm
from repro_torch.nn.init import normal_init, scaled_init
from repro_torch.nn.pytree import tree_stack

_F32 = torch.float32


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _ln_init(L, d, dtype, device):
    pre = () if L is None else (L,)
    return {"s": torch.ones(pre + (d,), dtype=dtype, device=device),
            "b": torch.zeros(pre + (d,), dtype=dtype, device=device)}


def _ln(x, p, eps):
    return layer_norm(x, p["s"], p["b"], eps)


def _mlp_init(key, L, d, f, dtype):
    pre = () if L is None else (L,)
    k1, k2 = prng.split(key, 2)
    return {
        "wi": scaled_init(k1, pre + (d, f), dtype),
        "bi": torch.zeros(pre + (f,), dtype=dtype, device=key.device),
        "wo": scaled_init(k2, pre + (f, d), dtype),
        "bo": torch.zeros(pre + (d,), dtype=dtype, device=key.device),
    }


def _mlp(p, x):
    """GELU MLP, the activation in float32 with ``jax.nn.gelu``'s default
    tanh approximation."""
    h = x @ p["wi"] + p["bi"]
    h = F.gelu(h.to(_F32), approximate="tanh").to(x.dtype)
    return h @ p["wo"] + p["bo"]


def _sinusoid(n_pos: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n_pos, dtype=_F32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=_F32, device=device)[None, :]
    ang = pos * torch.exp(-dim * math.log(10000.0) / (d // 2 - 1))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init(cfg: ArchConfig, key) -> dict:
    """Random parameters on the key's device: the JAX package's from the
    same key (12 keys split, 7 used, in its order)."""
    dtype = _dtype(cfg)
    dev = key.device
    d, Le, Ld = cfg.d_model, cfg.n_enc_layers, cfg.n_layers
    ks = prng.split(key, 12)
    enc = {
        "attn": B.attn_init(ks[0], cfg, Le, dtype, bias=True),
        "ln1": _ln_init(Le, d, dtype, dev),
        "mlp": _mlp_init(ks[1], Le, d, cfg.d_ff, dtype),
        "ln2": _ln_init(Le, d, dtype, dev),
    }
    dec = {
        "attn": B.attn_init(ks[2], cfg, Ld, dtype, bias=True),
        "ln1": _ln_init(Ld, d, dtype, dev),
        "xattn": B.attn_init(ks[3], cfg, Ld, dtype, bias=True),
        "lnx": _ln_init(Ld, d, dtype, dev),
        "mlp": _mlp_init(ks[4], Ld, d, cfg.d_ff, dtype),
        "ln2": _ln_init(Ld, d, dtype, dev),
    }
    return {
        "enc_layers": enc,
        "enc_final_ln": _ln_init(None, d, dtype, dev),
        "dec_layers": dec,
        "dec_final_ln": _ln_init(None, d, dtype, dev),
        "embed": normal_init(ks[5], (cfg.padded_vocab, d), dtype),
        # learned decoder positions, sized for the serve cache
        "pos_embed": normal_init(ks[6], (max(cfg.max_decode_len, 1), d),
                                 dtype),
    }


def _run_layers(body, layers, n: int, x, remat: bool):
    """x through ``body(lp, x)`` for each of the n stacked layers; under
    ``remat`` (with autograd on) each layer is one non-reentrant
    checkpoint."""
    remat = remat and torch.is_grad_enabled()
    for i in range(n):
        x = _remat(lambda x, lp=_layer(layers, i): body(lp, x), x, remat)
    return x


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ArchConfig, params, audio_embeds, remat: bool = True):
    """audio_embeds (B, F, d) -> encoder states (B, F, d)."""
    audio_embeds = audio_embeds.to(params["embed"].dtype)
    Bb, F_, d = audio_embeds.shape
    x = audio_embeds + _sinusoid(F_, d, audio_embeds.device).to(
        audio_embeds.dtype)[None]
    positions = torch.arange(F_, dtype=torch.int32,
                             device=x.device)[None].expand(Bb, F_)

    def body(lp, x):
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        x = x + B.attn_apply(lp["attn"], cfg, h, positions, causal=False,
                             use_rope=False)
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        return x + _mlp(lp["mlp"], h)

    x = _run_layers(body, params["enc_layers"], cfg.n_enc_layers, x, remat)
    return _ln(x, params["enc_final_ln"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder forward (training: teacher forcing)
# ---------------------------------------------------------------------------

def _pos_embed(params, pos):
    """Learned positions, clamped at the table's last row."""
    table = params["pos_embed"]
    return table[torch.clamp(pos, max=table.shape[0] - 1)]


def forward_hidden(cfg: ArchConfig, params, batch, ctx=None,
                   remat: bool = True):
    """batch: {"audio_embeds": (B,F,d), "tokens": (B,S)} -> final-normed
    decoder states (B,S,d)."""
    enc = encode(cfg, params, batch["audio_embeds"], remat)
    tokens = batch["tokens"]
    Bb, S = tokens.shape
    steps = torch.arange(S, dtype=torch.int32, device=tokens.device)
    positions = steps[None].expand(Bb, S)
    x = (B.embed_lookup(params["embed"], tokens)
         + _pos_embed(params, steps)[None])

    def body(lp, x):
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        x = x + B.attn_apply(lp["attn"], cfg, h, positions, use_rope=False)
        h = _ln(x, lp["lnx"], cfg.norm_eps)
        x = x + B.cross_attn_apply(lp["xattn"], cfg, h, enc)
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        return x + _mlp(lp["mlp"], h)

    x = _run_layers(body, params["dec_layers"], cfg.n_layers, x, remat)
    return _ln(x, params["dec_final_ln"], cfg.norm_eps)


def forward(cfg: ArchConfig, params, batch, ctx=None, remat: bool = True):
    """Returns (logits (B,S,Vp), aux 0)."""
    x = forward_hidden(cfg, params, batch, ctx, remat)
    return _logits(cfg, params, x), torch.zeros((), dtype=_F32,
                                                device=x.device)


def prefill(cfg: ArchConfig, params, batch, ctx=None):
    """Next-token logits (B,Vp) of ``forward``'s last position; the LM head
    runs on that position only."""
    x = forward_hidden(cfg, params, batch, ctx, remat=False)
    return _logits(cfg, params, x[:, -1])


def loss(cfg: ArchConfig, params, batch, ctx=None):
    """Mean next-token cross-entropy of batch {"audio_embeds", "tokens",
    "labels", optional "mask"}."""
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
    return {
        "self": B.attn_cache_init(cfg, cfg.n_layers, batch, cache_len,
                                  dtype, dev),
        "cross": B.cross_attn_cache_init(cfg, cfg.n_layers, batch,
                                         cfg.n_audio_frames, dtype, dev),
    }


def prefill_cross(cfg: ArchConfig, params, cache, audio_embeds):
    """Run the encoder once and fill the per-layer cross K/V cache."""
    enc = encode(cfg, params, audio_embeds)
    layers = [B.cross_attn_prefill_cache(_layer(params["dec_layers"], i)
                                         ["xattn"], cfg, enc)
              for i in range(cfg.n_layers)]
    return {"self": cache["self"],
            "cross": tree_stack(layers)}


def decode_step(cfg: ArchConfig, params, cache, batch, ctx=None):
    """batch: {"token": (B,), "pos": (B,)} -> (logits (B,Vp), new_cache);
    the cross K/V must be prefilled. The given cache is not written."""
    token, pos = batch["token"], batch["pos"]
    x = (B.embed_lookup(params["embed"], token)
         + _pos_embed(params, pos))[:, None, :]
    new_self = []
    for i in range(cfg.n_layers):
        lp = _layer(params["dec_layers"], i)
        h = _ln(x, lp["ln1"], cfg.norm_eps)
        y, nc = B.attn_decode(lp["attn"], cfg, h, pos,
                              _layer(cache["self"], i), use_rope=False)
        new_self.append(nc)
        x = x + y
        h = _ln(x, lp["lnx"], cfg.norm_eps)
        x = x + B.cross_attn_decode(lp["xattn"], cfg, h,
                                    _layer(cache["cross"], i))
        h = _ln(x, lp["ln2"], cfg.norm_eps)
        x = x + _mlp(lp["mlp"], h)
    x = _ln(x, params["dec_final_ln"], cfg.norm_eps)
    logits = _logits(cfg, params, x)[:, 0, :]
    return logits, {"self": tree_stack(new_self), "cross": cache["cross"]}
