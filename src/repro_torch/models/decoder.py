"""Decoder-only language model (port of ``repro.models.decoder``).

Layers are grouped into *segments*, contiguous runs of identical layers
whose parameters are stacked along a leading layer axis; the forward and
the decode step loop over each segment's layers in Python (the JAX
package scans them). The port trains and serves all four kinds: dense
(attention + SwiGLU: tinyllama, olmo, qwen3, granite), moe (attention +
the capacity-dispatched MoE FFN: deepseek-moe, qwen3-moe; deepseek's
first layer is dense), ssm (Mamba-2: mamba2-130m) and hybrid (parallel
attention ∥ Mamba-2 heads, then a SwiGLU FFN: hymba).

Training: ``loss`` is the forward with one ``torch.utils.checkpoint`` per
layer under ``remat`` (the JAX package's ``jax.checkpoint`` of the scan
body), so a backward recomputes each layer's forward, and ``chunked_ce``,
whose chunks recompute their logits in the backward. So a training step
launches the attention or SSD kernel twice per layer, and the (B, S, V)
float32 logits never exist whole. A layer returns its MoE router aux
(zero for the other kinds) beside its output, and ``loss`` adds
``router_aux_weight`` times their sum. ``ctx`` goes to ``moe_apply``,
which raises on a multi-device mesh; the other blocks ignore it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from repro_torch import prng
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models.config import ArchConfig
from repro_torch.nn.init import normal_init, scaled_init
from repro_torch.nn.pytree import tree_map, tree_stack
from repro_torch.sharding.context import has_mesh, is_dtensor, mesh_scope
from repro_torch.sharding.specs import P, constrain, whole_dim


@dataclass(frozen=True)
class SegmentSpec:
    kind: str          # dense | moe | ssm | hybrid
    n_layers: int
    window: int = 0    # 0 = full attention
    d_ff: int = 0      # dense-FFN hidden size (0 for ssm/moe kinds)


def _per_layer_plan(cfg: ArchConfig) -> list[tuple]:
    """(kind, window, d_ff) for each layer index."""
    out = []
    for i in range(cfg.n_layers):
        w = 0
        if cfg.sliding_window and i not in cfg.global_attn_layers:
            w = cfg.sliding_window
        if cfg.family == "ssm":
            out.append(("ssm", 0, 0))
        elif cfg.family == "hybrid":
            out.append(("hybrid", w, cfg.d_ff))
        elif cfg.family == "moe":
            if i < cfg.first_dense_layers:
                out.append(("dense", w, cfg.first_dense_d_ff or cfg.d_ff))
            else:
                out.append(("moe", w, 0))
        else:
            out.append(("dense", w, cfg.d_ff))
    return out


def segment_plan(cfg: ArchConfig) -> list[SegmentSpec]:
    """Group contiguous identical layers into segments."""
    plan, run = [], None
    for kind, w, ff in _per_layer_plan(cfg):
        if run and run[0] == (kind, w, ff):
            run[1] += 1
        else:
            if run:
                plan.append(SegmentSpec(run[0][0], run[1], run[0][1],
                                        run[0][2]))
            run = [(kind, w, ff), 1]
    plan.append(SegmentSpec(run[0][0], run[1], run[0][1], run[0][2]))
    return plan


def _layer_init(key, cfg: ArchConfig, seg: SegmentSpec, dtype):
    L = seg.n_layers
    ks = prng.split(key, 6)
    dev = key.device
    parametric = cfg.norm_type != "nonparam_ln"
    ones = lambda: torch.ones((L, cfg.d_model), dtype=dtype, device=dev)
    p = {}
    if seg.kind in ("dense", "moe", "hybrid"):
        p["attn"] = B.attn_init(ks[0], cfg, L, dtype)
    if seg.kind in ("ssm", "hybrid"):
        p["ssm"] = B.ssm_init(ks[1], cfg, L, dtype)
    if parametric:
        p["ln1"] = ones()
    if seg.kind == "hybrid":
        # per-branch output norms, then the branches are averaged (hymba)
        p["bn_attn"] = ones()
        p["bn_ssm"] = ones()
    if seg.kind in ("dense", "hybrid"):
        p["ffn"] = B.ffn_init(ks[2], cfg, L, dtype, d_ff=seg.d_ff)
        if parametric:
            p["ln2"] = ones()
    elif seg.kind == "moe":
        p["moe"] = B.moe_init(ks[3], cfg, L, dtype)
        if parametric:
            p["ln2"] = ones()
    return p


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def init(cfg: ArchConfig, key) -> dict:
    """Random parameters on the key's device (see ``nn.init``)."""
    dtype = _dtype(cfg)
    plan = segment_plan(cfg)
    ks = prng.split(key, len(plan) + 3)
    params = {
        "embed": normal_init(ks[0], (cfg.padded_vocab, cfg.d_model), dtype),
        "segments": [_layer_init(ks[2 + i], cfg, seg, dtype)
                     for i, seg in enumerate(plan)],
    }
    if cfg.norm_type != "nonparam_ln":
        params["final_norm"] = torch.ones((cfg.d_model,), dtype=dtype,
                                          device=key.device)
    if not cfg.tie_embeddings:
        params["lm_head"] = scaled_init(ks[1],
                                        (cfg.d_model, cfg.padded_vocab), dtype)
    return params


def _layer(sp, i: int):
    """Layer i of a segment's stacked parameters (or cache)."""
    return tree_map(lambda a: a[i], sp)


def _gather_point(h, ctx):
    """The levers on the re-gather of a block's input under sequence
    sharding: ``gather_once`` forces one replicated gather per block;
    ``quant_gather`` sends int8 values and a float32 scale per row
    instead (half the bytes of bf16), dequantised on the replicated
    side. The int8 round trip runs whenever a mesh is set, on any mesh
    size, as in the JAX package. Otherwise nothing."""
    if not has_mesh(ctx) or not ctx.seq_shard:
        return h
    if h.dim() != 3 or h.shape[1] <= 1:
        return h
    rep = P(ctx.data_spec_axes, None, None)
    if ctx.quant_gather:
        hf = h.to(torch.float32)
        scale = torch.amax(torch.abs(hf), dim=-1, keepdim=True) / 127.0 \
            + 1e-12
        q = torch.clamp(torch.round(hf / scale), -127, 127).to(torch.int8)
        q = constrain(q, rep, ctx)
        scale = constrain(scale, rep, ctx)
        return (q.to(torch.float32) * scale).to(h.dtype)
    if ctx.gather_once:
        return constrain(h, rep, ctx)
    return h


def _layer_apply(cfg: ArchConfig, seg: SegmentSpec, lp, x, positions, ctx):
    """One layer's forward: (x, aux), aux the MoE router loss (zero for
    the other kinds)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = _gather_point(B._norm(cfg, x, lp.get("ln1")), ctx)
    if seg.kind == "ssm":
        x = x + B.ssm_apply(lp["ssm"], cfg, h)
    elif seg.kind == "hybrid":
        a = B.attn_apply(lp["attn"], cfg, h, positions, window=seg.window,
                         ctx=ctx)
        s = B.ssm_apply(lp["ssm"], cfg, h)
        x = x + 0.5 * (B.rms_norm(a, lp["bn_attn"], cfg.norm_eps)
                       + B.rms_norm(s, lp["bn_ssm"], cfg.norm_eps))
    else:
        x = x + B.attn_apply(lp["attn"], cfg, h, positions,
                             window=seg.window, ctx=ctx)
    if seg.kind in ("dense", "hybrid"):
        x = x + B.ffn_apply(lp["ffn"],
                            _gather_point(B._norm(cfg, x, lp.get("ln2")),
                                          ctx))
    elif seg.kind == "moe":
        y, a = B.moe_apply(lp["moe"], cfg, B._norm(cfg, x, lp.get("ln2")),
                           ctx)
        x = x + y
        aux = aux + a
    return x, aux


def _seq_constraint(x, ctx):
    """Sequence sharding of the residual stream: the carry (and so each
    layer's saved input) shards S over "model", cutting saved-activation
    memory by the TP degree; DTensor gathers before attention and
    reduce-scatters after the projections."""
    if not has_mesh(ctx) or not ctx.seq_shard:
        return x
    if x.dim() != 3 or x.shape[1] % ctx.model_size or x.shape[1] <= 1:
        return x
    return constrain(x, P(ctx.data_spec_axes, ctx.model_axis, None), ctx)


def _remat(fn, x, remat: bool):
    """fn(x), under one non-reentrant checkpoint when ``remat``: the
    backward recomputes its activations."""
    if remat:
        return torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False)
    return fn(x)


def _run_segment(cfg, seg, sp, x, positions, ctx, remat: bool):
    """The segment's layers in order: (x, the sum of their aux). Under
    ``remat`` (with autograd on) each layer is one non-reentrant
    checkpoint: its activations are recomputed in the backward, as the
    JAX package's ``jax.checkpoint`` of the scan body does."""
    remat = remat and torch.is_grad_enabled()
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    def body(x, i):
        y, a = _layer_apply(cfg, seg, _layer(sp, i), _seq_constraint(x, ctx),
                            positions, ctx)
        return _seq_constraint(y, ctx), a

    for i in range(seg.n_layers):
        x, a = _remat(lambda x, i=i: body(x, i), x, remat)
        aux = aux + a
    return x, aux


def _logits(cfg: ArchConfig, params, x):
    x = whole_dim(x) if x.dim() == 3 else x
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, B.NEG_INF)
    return logits


def forward_hidden(cfg: ArchConfig, params, batch, ctx=None,
                   remat: bool = True):
    """Final-normed hidden states (B,S,d) + aux losses (the MoE layers'
    router loss, summed; zero without MoE layers)."""
    tokens = batch["tokens"]
    Bb, S = tokens.shape
    with mesh_scope(ctx):
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(Bb, S)
        x = B.embed_lookup(params["embed"], tokens)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for seg, sp in zip(segment_plan(cfg), params["segments"]):
            x, a = _run_segment(cfg, seg, sp, x, positions, ctx, remat)
            aux = aux + a
        return B._norm(cfg, x, params.get("final_norm")), aux


def forward(cfg: ArchConfig, params, batch, ctx=None, remat: bool = True):
    """batch: {"tokens": (B,S) int}. Returns (logits (B,S,Vp), aux)."""
    x, aux = forward_hidden(cfg, params, batch, ctx, remat)
    with mesh_scope(ctx):
        return _logits(cfg, params, x), aux


def prefill(cfg: ArchConfig, params, batch, ctx=None):
    """Next-token logits (B,Vp) of ``forward``'s last position; the LM head
    runs on that position only."""
    x, _ = forward_hidden(cfg, params, batch, ctx, remat=False)
    with mesh_scope(ctx):
        return _logits(cfg, params, whole_dim(x)[:, -1])


def _chunk_nll(cfg: ArchConfig, params, x, labels, mask):
    """One chunk's summed NLL and weight: its logits, a float32
    log-sum-exp about the (constant) row max, the label's logit (on
    vocab-sharded DTensor logits through a one-hot sum, as the JAX
    package takes it: each rank's vocab slice and an all-reduce)."""
    lf = _logits(cfg, params, x).to(torch.float32)
    m = torch.amax(lf, dim=-1, keepdim=True).detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    if is_dtensor(lf):
        onehot = torch.arange(lf.shape[-1], device=lf.device) == \
            labels[..., None]
        ll = torch.sum(torch.where(onehot, lf, 0.0), dim=-1)
    else:
        ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    w = mask.to(torch.float32)
    return torch.sum((lse - ll) * w), torch.sum(w)


def chunked_ce(cfg: ArchConfig, params, x, labels, mask=None,
               chunk: int = 1024, ctx=None):
    """Cross-entropy without ever materialising (B, S, V) logits: S in
    chunks (the largest divisor of S not above ``chunk``), each chunk's
    logits and partial NLL under a non-reentrant checkpoint, so the
    backward recomputes the chunk's logits. Masked positions weigh 0; the
    mean is over the unmasked ones."""
    with mesh_scope(ctx):
        return _chunked_ce(cfg, params, x, labels, mask, chunk)


def _chunked_ce(cfg, params, x, labels, mask, chunk):
    x = whole_dim(x)
    Bb, S, _ = x.shape
    c = min(chunk, S)
    while S % c != 0:
        c -= 1
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32,
                          device=x.device)
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    grad = torch.is_grad_enabled()
    for z in range(0, S, c):
        args = (x[:, z:z + c], labels[:, z:z + c], mask[:, z:z + c])
        if grad:
            t, n = torch.utils.checkpoint.checkpoint(
                lambda *a: _chunk_nll(cfg, params, *a), *args,
                use_reentrant=False)
        else:
            t, n = _chunk_nll(cfg, params, *args)
        tot, cnt = tot + t, cnt + n
    return tot / torch.clamp(cnt, min=1.0)


def loss(cfg: ArchConfig, params, batch, ctx=None):
    """Mean next-token cross-entropy of batch {"tokens", "labels" (B, S),
    optional "mask"} plus the router aux term (zero without MoE)."""
    x, aux = forward_hidden(cfg, params, batch, ctx)
    ce = chunked_ce(cfg, params, x, batch["labels"], batch.get("mask"),
                    ctx=ctx)
    with mesh_scope(ctx):
        return ce + cfg.router_aux_weight * aux


# =========================================================================
# Serving (KV / SSM-state cache, single-token decode)
# =========================================================================

def init_cache(cfg: ArchConfig, batch: int, cache_len: int,
               device=None) -> dict:
    dev = resolve_device(device)
    dtype = _dtype(cfg)
    caches = []
    for seg in segment_plan(cfg):
        c = {}
        if seg.kind in ("dense", "moe", "hybrid"):
            clen = min(seg.window, cache_len) if seg.window > 0 else cache_len
            c["attn"] = B.attn_cache_init(cfg, seg.n_layers, batch, clen,
                                          dtype, dev)
        if seg.kind in ("ssm", "hybrid"):
            c["ssm"] = B.ssm_cache_init(cfg, seg.n_layers, batch, dtype, dev)
        caches.append(c)
    return {"segments": caches}


def _layer_decode(cfg: ArchConfig, seg: SegmentSpec, lp, lc, x, pos, ctx):
    new_c = {}
    h = B._norm(cfg, x, lp.get("ln1"))
    if seg.kind == "ssm":
        y, new_c["ssm"] = B.ssm_decode(lp["ssm"], cfg, h, lc["ssm"])
    elif seg.kind == "hybrid":
        a, new_c["attn"] = B.attn_decode(lp["attn"], cfg, h, pos, lc["attn"],
                                         window=seg.window)
        s, new_c["ssm"] = B.ssm_decode(lp["ssm"], cfg, h, lc["ssm"])
        y = 0.5 * (B.rms_norm(a, lp["bn_attn"], cfg.norm_eps)
                   + B.rms_norm(s, lp["bn_ssm"], cfg.norm_eps))
    else:
        y, new_c["attn"] = B.attn_decode(lp["attn"], cfg, h, pos, lc["attn"],
                                         window=seg.window)
    x = x + y
    if seg.kind in ("dense", "hybrid"):
        x = x + B.ffn_apply(lp["ffn"], B._norm(cfg, x, lp.get("ln2")))
    elif seg.kind == "moe":
        y2, _ = B.moe_apply(lp["moe"], cfg, B._norm(cfg, x, lp.get("ln2")),
                            ctx)
        x = x + y2
    return x, new_c


def decode_step(cfg: ArchConfig, params, cache, batch, ctx=None):
    """One serve step: batch {"token": (B,), "pos": (B,)} -> (logits (B,Vp),
    new_cache). The cache holds `cache_len` past positions (ring buffer);
    the given cache is not written."""
    with mesh_scope(ctx):
        return _decode_step(cfg, params, cache, batch, ctx)


def _decode_step(cfg: ArchConfig, params, cache, batch, ctx):
    token, pos = batch["token"], batch["pos"]
    x = B.embed_lookup(params["embed"], token)[:, None, :]
    new_segments = []
    for seg, sp, sc in zip(segment_plan(cfg), params["segments"],
                           cache["segments"]):
        layers = []
        for i in range(seg.n_layers):
            x, nc = _layer_decode(cfg, seg, _layer(sp, i), _layer(sc, i), x,
                                  pos, ctx)
            layers.append(nc)
        new_segments.append(tree_stack(layers))
    x = B._norm(cfg, x, params.get("final_norm"))
    logits = _logits(cfg, params, x)
    return logits[:, 0, :], {"segments": new_segments}
