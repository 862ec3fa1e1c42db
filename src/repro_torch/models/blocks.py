"""Building blocks of the decoder zoo (port of ``repro.models.blocks``).

Every block comes as an ``*_init`` returning a *stacked* parameter dict
with a leading layer axis L (the decoder loops over it) and apply
functions for the two execution modes:

  * ``*_apply``  — full-sequence training / prefill forward
  * ``*_decode`` — single-token serve step against a (possibly ring-buffer
    sliding-window) cache

Conventions:
  x          (B, S, d) activations
  positions  (B, S) or (B,) absolute int token positions
  window     0 = full causal attention; >0 = sliding window (ring cache)

The full-sequence forward runs its two sequence mixers through the
hand-written kernels: causal ``attn_apply`` through
``kernels.swa_attention`` and ``ssm_apply`` through ``kernels.ssd_scan``
(each takes its plain version on CPU tensors; each backward replays the
plain version). Non-causal self-attention (the whisper encoder), every
cross-attention and single-token decode are plain torch, as in the JAX
package, which has no kernel for them either; past
``QCHUNK_THRESHOLD`` tokens non-causal attention runs in query chunks.
Ported here: attention with GQA, MQA, qk-norm, biases, self and cross
(encoder-decoder, VLM), the ring-buffer KV cache in the model dtype or
int8 with float16 scales, SwiGLU FFN, the capacity-dispatched MoE FFN,
Mamba-2. The MoE layer has no kernel in the JAX package either: routing,
dispatch and combine are plain torch, the experts three batched matmuls.

Under a device mesh (DTensor activations) the kernels run on each rank's
local shard in a ``local_map`` region (batch over the data axes, heads
over "model" where they divide, the sequence whole), never on a DTensor;
``seq_attn`` keeps the queries sequence-sharded through a plain softmax
over the local query block; and the MoE runs expert parallelism:
``_moe_a2a`` (tokens to their experts' ranks and back with two
all-to-alls over "model") for many tokens, ``_moe_replicated_ep`` (each
"model" rank its expert slice, then an all-reduce) for few, the
counterparts of the JAX package's ``shard_map`` regions.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.kernels.ssd_scan.ops import chunk_len, ssd_scan
from repro_torch.kernels.swa_attention.ops import repeat_kv as _repeat_kv
from repro_torch.kernels.swa_attention.ops import swa_attention
from repro_torch.models.config import ArchConfig
from repro_torch.nn.common import (
    apply_rope, layer_norm, rms_norm, rope_angles, softplus, swiglu,
)
from repro_torch.nn.init import normal_init, scaled_init, uniform_init
from repro_torch.sharding.context import has_mesh, is_dtensor
from repro_torch.sharding.specs import (P, constrain, local_placed,
                                        local_region, whole_dim, whole_grad)

NEG_INF = -1e30
_F32 = torch.float32


def embed_lookup(table, ids):
    """``table[ids]``. On a DTensor table each rank looks its ids up in its
    own rows: where the rows are split (over "model", vocab-parallel) an
    id outside them reads a zero row and the partial rows add up across
    those ranks; the ids keep their batch split."""
    if not is_dtensor(table):
        return table[ids]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh = table.device_mesh
    table = whole_dim(table, 1)
    if not is_dtensor(ids):
        ids = _replicated(ids, mesh)
    rows = [p.is_shard(0) for p in table.placements]
    ids = ids.redistribute(mesh, [Replicate() if r else p for r, p in
                                  zip(rows, ids.placements)])
    (n, _), (off, _) = compute_local_shape_and_global_offset(
        table.shape, mesh, table.placements)
    split = n != table.shape[0]

    def local(t, i):
        if not split:
            return t[i]
        hit = (i >= off) & (i < off + n)
        return t[torch.where(hit, i - off, 0)] * hit[..., None].to(t.dtype)

    out = tuple(Partial() if r else (Shard(p.dim) if p.is_shard() else p)
                for r, p in zip(rows, ids.placements))
    return local_placed(local, mesh, (table.placements, ids.placements),
                        out)(table, ids)


def _pre(L) -> tuple:
    """Leading stack axes: None -> (), int -> (L,), tuple -> tuple."""
    if L is None:
        return ()
    if isinstance(L, (tuple, list)):
        return tuple(L)
    return (L,)


def _norm(cfg: ArchConfig, x, scale):
    if cfg.norm_type == "rmsnorm":
        return rms_norm(x, scale, cfg.norm_eps)
    if cfg.norm_type == "nonparam_ln":
        return layer_norm(x, None, None, cfg.norm_eps)
    if cfg.norm_type == "layernorm":
        s, b = (scale if isinstance(scale, tuple) else (scale, None))
        return layer_norm(x, s, b, cfg.norm_eps)
    raise ValueError(cfg.norm_type)


def norm_init(cfg: ArchConfig, L: int | None, dtype, device):
    """Stacked norm scale, or None for non-parametric (olmo)."""
    if cfg.norm_type == "nonparam_ln":
        return None
    return torch.ones(_pre(L) + (cfg.d_model,), dtype=dtype, device=device)


# =========================================================================
# Attention (self / cross, GQA, qk-norm, sliding window, ring-buffer cache)
# =========================================================================

def attn_init(key, cfg: ArchConfig, L: int | None, dtype, bias: bool = False):
    """Stacked attention weights; ``bias`` adds the q, v and output
    biases (whisper's; no k bias), zero-initialised."""
    H, KV, hd, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    pre = _pre(L)
    ks = prng.split(key, 4)
    dev = key.device
    p = {
        "wq": scaled_init(ks[0], pre + (d, H * hd), dtype),
        "wk": scaled_init(ks[1], pre + (d, KV * hd), dtype),
        "wv": scaled_init(ks[2], pre + (d, KV * hd), dtype),
        "wo": scaled_init(ks[3], pre + (H * hd, d), dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones(pre + (hd,), dtype=dtype, device=dev)
        p["k_norm"] = torch.ones(pre + (hd,), dtype=dtype, device=dev)
    if bias:
        p["bq"] = torch.zeros(pre + (H * hd,), dtype=dtype, device=dev)
        p["bv"] = torch.zeros(pre + (KV * hd,), dtype=dtype, device=dev)
        p["bo"] = torch.zeros(pre + (d,), dtype=dtype, device=dev)
    return p


def _split_heads(t, B: int, S: int, n: int, hd: int):
    """(B, S, n·hd) -> (B, S, n, hd). A DTensor whose last dim is split
    over a mesh dim the n heads do not divide is gathered on that dim
    first (DTensor may shard a projection's columns wherever they divide,
    heads or not)."""
    if is_dtensor(t):
        from torch.distributed.tensor import Replicate
        mesh, last = t.device_mesh, t.dim() - 1
        pl = [Replicate() if p.is_shard(last) and n % mesh.size(md) else p
              for md, p in enumerate(t.placements)]
        if pl != list(t.placements):
            t = t.redistribute(mesh, pl)
    return t.reshape(B, S, n, hd)


def _project_qkv(p, cfg: ArchConfig, xq, xkv, cos_q=None, sin_q=None,
                 cos_k=None, sin_k=None):
    """Project q from xq and k,v from xkv; apply qk-norm and rope."""
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Bq, Sq, _ = xq.shape
    Bk, Sk, _ = xkv.shape
    q = xq @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    k = xkv @ p["wk"]
    v = xkv @ p["wv"]
    if "bv" in p:
        v = v + p["bv"]
    q = _split_heads(q, Bq, Sq, H, hd)
    k = _split_heads(k, Bk, Sk, KV, hd)
    v = _split_heads(v, Bk, Sk, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cos_q is not None:
        q = apply_rope(q, cos_q, sin_q)
    if cos_k is not None:
        k = apply_rope(k, cos_k, sin_k)
    return q, k, v


def _sdpa_core(q, k, v, mask):
    """Softmax attention: q (B,Sq,H,hd), k/v (B,Sk,H,hd), mask (B,1,Sq,Sk)
    or None -> (B,Sq,H,hd). Softmax statistics in fp32; the score and
    probability tensors stay in the activation dtype, as in the JAX
    package."""
    if is_dtensor(q) and sum(p.is_shard(0) for p in q.placements) > 1:
        return _sdpa_local(q, k, v, mask)
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    m = torch.amax(scores, dim=-1, keepdim=True).detach()
    p = torch.exp(scores - m)
    l = torch.clamp(torch.sum(p, dim=-1, keepdim=True, dtype=_F32), min=1e-30)
    probs = p / l.to(p.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def _sdpa_local(q, k, v, mask):
    """``_sdpa_core`` of DTensors on each rank's local batch and heads (the
    keys whole): DTensor's einsum miscomputes the local shapes of a batch
    split over two mesh axes (the multi-pod mesh's ("pod", "data"))."""
    b, h = _mesh_specs(q.device_mesh, q.shape[0], (q.shape[2],))
    if mask is not None and not is_dtensor(mask):
        mask = _replicated(mask, q.device_mesh)
    qs = P(b, None, h, None)
    ms = None if mask is None else P(b, None, None, None)
    return local_region(_sdpa_core, q.device_mesh, (qs, qs, qs, ms), qs)(
        q, k, v, mask)


def _out_proj(o, p):
    """(B, S, H·hd) through ``wo``, plus ``bo`` where present (its
    gradient taken whole in S, ``whole_grad``)."""
    y = o @ p["wo"]
    return whole_grad(y + p["bo"] if "bo" in p else y)


def _sdpa(q, k, v, mask, p):
    o = _sdpa_core(q, k, v, mask)
    return _out_proj(o.reshape(o.shape[0], o.shape[1], -1), p)


# sequences longer than this compute non-causal attention in query chunks:
# exact softmax per chunk, O(S·chunk) memory instead of O(S²)
QCHUNK_THRESHOLD = 8192
QCHUNK = 512


def _attn_qchunked(q, k, v, positions, causal, window, chunk=QCHUNK):
    """``_sdpa_core`` over chunks of queries (the largest divisor of S not
    above ``chunk``), each chunk's mask from the positions: k/v (B, S, H,
    hd) already repeated to H heads."""
    B, S, H, hd = q.shape
    c = min(chunk, S)
    while S % c != 0:
        c -= 1
    pk = positions[:, None, :]                               # (B,1,S)
    outs = []
    for z in range(0, S, c):
        pq = positions[:, z:z + c, None]                     # (B,c,1)
        mask = torch.ones((B, c, S), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pk <= pq
        if window > 0:
            mask &= pk > pq - window
        outs.append(_sdpa_core(q[:, z:z + c], k, v, mask[:, None]))
    return torch.cat(outs, dim=1)


def _mesh_specs(mesh, B: int, heads: tuple):
    """(batch entry, heads entry) of a kernel's local region on ``mesh``:
    the batch over the data axes where it divides them, the heads over
    "model" where every count in ``heads`` divides it; else replicated."""
    names = tuple(mesh.mesh_dim_names)
    data = tuple(a for a in names if a != "model")
    dsz = 1
    for a in data:
        dsz *= mesh.size(names.index(a))
    ms = mesh.size(names.index("model")) if "model" in names else 1
    b = (data if len(data) > 1 else data[0]) if data and B % dsz == 0 \
        else None
    h = "model" if ms > 1 and all(n % ms == 0 for n in heads) else None
    return b, h


def _swa_local(q, k, v, window: int):
    """Kernel #6 on DTensors: each rank's local batch and heads, the
    sequence whole."""
    b, h = _mesh_specs(q.device_mesh, q.shape[0], (q.shape[2], k.shape[2]))
    spec = P(b, None, h, None)
    return local_region(lambda q, k, v: swa_attention(q, k, v, window),
                        q.device_mesh, (spec, spec, spec), spec)(q, k, v)


def _seq_attn_local(q, k, v, positions, causal: bool, window: int, ctx):
    """``seq_attn``: the queries keep the residual's sequence sharding and
    only K/V are gathered; each rank runs the plain softmax over its
    query block against the whole K/V (kernel #6 takes whole sequences)."""
    dp, m = ctx.data_spec_axes, ctx.model_axis

    def local(q, k, v, pq, pk):
        k = _repeat_kv(k, q.shape[2])
        v = _repeat_kv(v, q.shape[2])
        mask = torch.ones((q.shape[0], q.shape[1], k.shape[1]),
                          dtype=torch.bool, device=q.device)
        if causal:
            mask &= pk[:, None, :] <= pq[:, :, None]
        if window > 0:
            mask &= pk[:, None, :] > pq[:, :, None] - window
        return _sdpa_core(q, k, v, mask[:, None])

    if not is_dtensor(positions):      # a plain tensor reaches local_map whole
        positions = _replicated(positions, ctx.mesh)
    qs, kvs = P(dp, m, None, None), P(dp, None, None, None)
    q = constrain(q, qs, ctx)
    k = constrain(k, kvs, ctx)
    v = constrain(v, kvs, ctx)
    return local_region(local, ctx.mesh,
                        (qs, kvs, kvs, P(dp, m), P(dp, None)), qs)(
        q, k, v, positions, positions)


def attn_apply(p, cfg: ArchConfig, x, positions, *, window: int = 0,
               causal: bool = True, use_rope: bool = True, ctx=None):
    """Full-sequence self-attention (training / prefill). Causal attention
    runs through ``kernels.swa_attention``, which bands by row index, so
    positions must be ``arange(S)`` in every row, as the models pass them
    (they also give the rope angles). Non-causal attention (the whisper
    encoder) is the plain softmax, its mask the window's alone, in query
    chunks past ``QCHUNK_THRESHOLD``.

    ``ctx.seq_attn`` under a sequence-sharded mesh ctx, for GQA/MQA
    (under MHA the K/V gather is full-size and the forced layout hurts):
    queries stay sequence-sharded through the whole attention and only
    K/V, a kv_heads/heads fraction of the bytes, are gathered."""
    x = whole_dim(x)
    B, S, _ = x.shape
    cos = sin = None
    if use_rope:
        cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
    q, k, v = _project_qkv(p, cfg, x, x, cos, sin, cos, sin)
    if (has_mesh(ctx) and ctx.seq_shard and ctx.seq_attn and S > 1
            and S % ctx.model_size == 0
            and 2 * cfg.n_kv_heads <= cfg.n_heads and is_dtensor(q)):
        o = _seq_attn_local(q, k, v, positions, causal, window, ctx)
        return _out_proj(o.reshape(B, S, -1), p)
    if causal:
        o = (_swa_local(q, k, v, window) if is_dtensor(q)
             else swa_attention(q, k, v, window))
        return _out_proj(o.reshape(B, S, -1), p)
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    if S > QCHUNK_THRESHOLD:
        o = _attn_qchunked(q, k, v, positions, False, window)
        return _out_proj(o.reshape(B, S, -1), p)
    mask = None
    if window > 0:
        mask = (positions[:, None, :] > positions[:, :, None] - window)[:, None]
    return _sdpa(q, k, v, mask, p)


def cross_attn_apply(p, cfg: ArchConfig, x, kv_states):
    """Cross-attention: q from text x, k/v from encoder/vision states."""
    q, k, v = _project_qkv(p, cfg, whole_dim(x), kv_states)
    k = _repeat_kv(k, cfg.n_heads)
    v = _repeat_kv(v, cfg.n_heads)
    return _sdpa(q, k, v, None, p)


def attn_cache_init(cfg: ArchConfig, L: int | None, batch: int,
                    cache_len: int, dtype, device) -> dict:
    """Ring-buffer KV cache. ``pos`` holds the absolute position stored in
    each slot (-1 = empty).

    kv_cache_dtype == "int8": K/V stored quantized with per-(slot, head)
    float16 scales, which halves the cache's bytes."""
    KV, hd = cfg.n_kv_heads, cfg.hd
    pre = _pre(L)
    zeros = lambda shape, dt: torch.zeros(pre + shape, dtype=dt,
                                          device=device)
    cache = {"pos": torch.full(pre + (batch, cache_len), -1,
                               dtype=torch.int32, device=device)}
    if cfg.kv_cache_dtype == "int8":
        for n in ("k", "v"):
            cache[n] = zeros((batch, cache_len, KV, hd), torch.int8)
            cache[n + "_scale"] = zeros((batch, cache_len, KV),
                                        torch.float16)
    else:
        for n in ("k", "v"):
            cache[n] = zeros((batch, cache_len, KV, hd), dtype)
    return cache


def _quant_kv(x):
    """(B, KV, hd) -> int8 values + per-head float16 scale: the scale
    max|x| / 127 + 1e-9 in float32, the values rounded half to even."""
    xf = x.to(_F32)
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0 + 1e-9
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.float16)


def _dequant_kv(q, scale, dtype):
    return (q.to(_F32) * scale.to(_F32)[..., None]).to(dtype)


def _ring_write(new: dict, n: str, bidx, slot, val):
    """``new[n]`` with row b's entry at ``slot[b]`` set to ``val[b]``: a
    copy written in place, or on a DTensor cache (sharded over batch or
    context) a select against the slot's one-hot, which every sharding
    partitions without communication."""
    buf = new[n]
    if is_dtensor(buf):
        hit = torch.arange(buf.shape[1], device=buf.device) == slot[:, None]
        hit = hit.reshape(hit.shape + (1,) * (buf.dim() - 2))
        new[n] = torch.where(hit, val[:, None].to(buf.dtype), buf)
    else:
        buf = buf.clone()
        buf[bidx, slot] = val
        new[n] = buf


def attn_decode(p, cfg: ArchConfig, x, pos, cache, *, window: int = 0,
                use_rope: bool = True):
    """Single-token decode. x (B,1,d); pos (B,) absolute position.

    Returns (y (B,1,d), new_cache). The cache slot is pos % cache_len — a
    ring buffer, which is exactly the sliding-window semantics when
    cache_len == window, and a plain append when cache_len >= max_len.
    The given cache is not written: the new one is a copy.
    """
    B = x.shape[0]
    cos = sin = None
    if use_rope:
        cos, sin = rope_angles(pos[:, None], cfg.hd, cfg.rope_theta)
    q, k, v = _project_qkv(p, cfg, x, x, cos, sin, cos, sin)
    new = dict(cache)
    slot = (pos % cache["k"].shape[1]).long()
    bidx = torch.arange(B, device=x.device)
    write = lambda n, val: _ring_write(new, n, bidx, slot, val)
    if cfg.kv_cache_dtype == "int8":
        for n, t in (("k", k), ("v", v)):
            qv, sc = _quant_kv(t[:, 0])
            write(n, qv)
            write(n + "_scale", sc)
        k_use = _dequant_kv(new["k"], new["k_scale"], x.dtype)
        v_use = _dequant_kv(new["v"], new["v_scale"], x.dtype)
    else:
        write("k", k[:, 0].to(cache["k"].dtype))
        write("v", v[:, 0].to(cache["v"].dtype))
        k_use, v_use = new["k"], new["v"]
    write("pos", pos.to(cache["pos"].dtype))
    cpos = new["pos"]
    kk = _repeat_kv(k_use, cfg.n_heads)
    vv = _repeat_kv(v_use, cfg.n_heads)
    valid = (cpos >= 0) & (cpos <= pos[:, None])
    if window > 0:
        valid &= cpos > (pos[:, None] - window)
    mask = valid[:, None, None, :]      # (B,1,1,Sc)
    return _sdpa(q, kk, vv, mask, p), new


def cross_attn_cache_init(cfg: ArchConfig, L: int | None, batch: int,
                          n_kv: int, dtype, device) -> dict:
    KV, hd = cfg.n_kv_heads, cfg.hd
    shape = _pre(L) + (batch, n_kv, KV, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cross_attn_prefill_cache(p, cfg: ArchConfig, kv_states):
    """Precompute cross-attention K/V from encoder states (done once)."""
    B, Sk, _ = kv_states.shape
    KV, hd = cfg.n_kv_heads, cfg.hd
    k = (kv_states @ p["wk"]).reshape(B, Sk, KV, hd)
    v = kv_states @ p["wv"]
    if "bv" in p:
        v = v + p["bv"]
    v = v.reshape(B, Sk, KV, hd)
    if cfg.qk_norm:
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    return {"k": k, "v": v}


def cross_attn_decode(p, cfg: ArchConfig, x, cache):
    """Decode-time cross-attention against precomputed K/V."""
    B = x.shape[0]
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, 1, cfg.n_heads, cfg.hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
    kk = _repeat_kv(cache["k"], cfg.n_heads)
    vv = _repeat_kv(cache["v"], cfg.n_heads)
    return _sdpa(q, kk, vv, None, p)


# =========================================================================
# Dense FFN
# =========================================================================

def ffn_init(key, cfg: ArchConfig, L: int | None, dtype, d_ff: int = 0):
    d, f = cfg.d_model, (d_ff or cfg.d_ff)
    pre = _pre(L)
    ks = prng.split(key, 3)
    return {
        "wg": scaled_init(ks[0], pre + (d, f), dtype),
        "wu": scaled_init(ks[1], pre + (d, f), dtype),
        "wd": scaled_init(ks[2], pre + (f, d), dtype),
    }


def ffn_apply(p, x):
    return whole_grad(swiglu(whole_dim(x), p["wg"], p["wu"], p["wd"]))


# =========================================================================
# Mixture of Experts
# =========================================================================

def moe_init(key, cfg: ArchConfig, L: int | None, dtype):
    d, E, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    pre = _pre(L)
    ks = prng.split(key, 5)
    p = {
        "router": scaled_init(ks[0], pre + (d, E), _F32),
        "we_g": scaled_init(ks[1], pre + (E, d, f), dtype),
        "we_u": scaled_init(ks[2], pre + (E, d, f), dtype),
        "we_d": scaled_init(ks[3], pre + (E, f, d), dtype),
    }
    if cfg.n_shared_experts:
        p["shared"] = ffn_init(ks[4], cfg, L, dtype,
                               d_ff=cfg.n_shared_experts * f)
    return p


def _one_hot(i, n: int):
    """Boolean one-hot of i over n classes (``F.one_hot`` checks its
    range on the host, a device synchronisation a call on the card)."""
    return i[..., None] == torch.arange(n, device=i.device)


def _moe_route(xt, router, cfg: ArchConfig):
    """Token-choice routing of xt (T, d) over all experts: the float32
    softmax of the router logits, its top k (largest first and, among
    equal probabilities, the lower expert first, as ``lax.top_k``: a
    stable descending sort), the top k renormalised, and the Switch
    load-balance aux E·Σ mean(probs)·mean(Σ_k one_hot(idx)).
    Returns (gate (T, k), idx (T, k), aux)."""
    E, k = cfg.n_experts, cfg.n_experts_per_tok
    probs = torch.softmax(xt.to(_F32) @ router, dim=-1)
    top, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = top[:, :k], order[:, :k]
    gate = gate / torch.sum(gate, dim=-1, keepdim=True)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(torch.sum(_one_hot(idx, E).to(_F32), dim=1), dim=0)
    return gate, idx, E * torch.sum(me * ce)


def _running_count(b):
    """Each element's place among the earlier elements of its bucket ``b``
    (the running count of a one-hot over the buckets, less one): a stable
    sort by bucket keeps each bucket's elements in order, so the place is
    the sorted position less the bucket's first."""
    order = torch.argsort(b, stable=True)
    by_b = b[order]
    first = torch.searchsorted(by_b, by_b)
    place = torch.arange(b.shape[0], device=b.device) - first
    return torch.empty_like(place).scatter_(0, order, place)


def _moe_slots(idx, cfg: ArchConfig, e_off, e_num: int):
    """Capacity dispatch of the token-major (T·k) slots onto the local
    experts [e_off, e_off + e_num): cap = max(int(capacity_factor·T·k/E),
    4); a slot's position in its expert is the count of the earlier slots
    routed there (the reference's running count over a one-hot; here a
    stable sort by expert keeps each expert's slots in order, so a slot's
    position is its place in the sorted order less its expert's first).
    Returns (cap, keep, target): ``keep`` marks the local slots within
    capacity, ``target`` their row of the (e_num·cap) expert buffer and
    every other slot's the overflow row e_num·cap."""
    T, k = idx.shape
    cap = max(int(cfg.capacity_factor * T * k / cfg.n_experts), 4)
    a = idx.reshape(T * k)
    local = (a >= e_off) & (a < e_off + e_num)
    e_loc = torch.where(local, a - e_off, e_num)
    slot = _running_count(e_loc)
    keep = local & (slot < cap)
    return cap, keep, torch.where(keep, e_loc * cap + slot, e_num * cap)


def _moe_local(xt, p, cfg: ArchConfig, e_off, e_num: int, t_scale: int):
    """Token-choice top-k MoE of xt (T, d) over the local expert slice
    [e_off, e_off + e_num), whose stacked weights ``p`` holds; the routing
    is over all experts. Returns (out (T, d), aux). ``t_scale`` (the
    token replication of expert parallelism) is unused, as in the JAX
    package.

    Dispatch: each kept slot owns one row of the expert buffer and writes
    its token there; the dropped slots write theirs to the overflow row,
    which is cut off, and read back the zero row appended to the experts'
    output, so they add nothing and take no gradient. The experts are three batched matmuls over (e_num,
    cap, d), ``silu(h_g) · h_u`` in the native dtype. Combine: each
    token's k gated contributions added in slot order in the native
    dtype, as the reference's scatter-add adds them (an atomic
    ``index_add_`` would add them in arrival order on the card, so a
    checkpointed layer's recompute would not be its forward)."""
    T, d = xt.shape
    gate, idx, aux = _moe_route(xt, p["router"], cfg)
    cap, _, target = _moe_slots(idx, cfg, e_off, e_num)
    k = idx.shape[1]
    rows = xt[:, None, :].expand(T, k, d).reshape(T * k, d)
    xin = xt.new_zeros((e_num * cap + 1, d)).index_put((target,), rows)
    xin = xin[:-1].reshape(e_num, cap, d)
    h = F.silu(torch.bmm(xin, p["we_g"])) * torch.bmm(xin, p["we_u"])
    y_e = torch.bmm(h, p["we_d"])
    y_flat = torch.cat([y_e.reshape(e_num * cap, d), xt.new_zeros((1, d))])
    g = gate.to(xt.dtype).reshape(T, k, 1)
    y = y_flat[target].reshape(T, k, d) * g
    out = y[:, 0]
    for j in range(1, k):
        out = out + y[:, j]
    return out, aux


def _moe_local_dynamic(xt, p, cfg: ArchConfig, e_off, e_num: int):
    """``_moe_local`` with a tensor (rank-dependent) expert offset."""
    return _moe_local(xt, p, cfg, e_off, e_num, 1)


class _RankSum(torch.autograd.Function):
    """The sum over the ranks of ``groups`` (one group after another) of
    one tensor each, replicated on every rank: all-reduces, or
    (``ordered``) all-gathers added up in rank order, so every rank gets
    the same bits in a fixed order. Its gradient is the same sum of the
    output's gradients (psum's transpose, as ``local_placed`` needs)."""

    @staticmethod
    def forward(ctx_, x, groups: tuple, ordered: bool):
        import torch.distributed._functional_collectives as fc
        ctx_.groups = groups
        for group in groups:
            if not ordered:
                x = _wait(fc.all_reduce(x, "sum", group))
                continue
            parts = _wait(fc.all_gather_tensor(x[None], 0, group))
            x = parts[0]
            for i in range(1, parts.shape[0]):
                x = x + parts[i]
        return x

    @staticmethod
    def backward(ctx_, g):
        import torch.distributed._functional_collectives as fc
        for group in ctx_.groups:
            g = _wait(fc.all_reduce(g, "sum", group))
        return g, None, None


def _wait(t):
    return t.wait() if hasattr(t, "wait") else t


def _all_to_all(x, group, grad: bool = True):
    """Row block r of x (ms·c, ...) to rank r of ``group``; block j of the
    result came from rank j."""
    import torch.distributed._functional_collectives as fc
    if grad:
        return _wait(fc.all_to_all_single_autograd(x, None, None, group))
    return _wait(fc.all_to_all_single(x, None, None, group))


def _replicated(x, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _experts(p):
    return tuple(p[n] for n in ("router", "we_g", "we_u", "we_d"))


def _moe_a2a(x3, p, cfg: ArchConfig, ctx, slots: dict | None = None):
    """All-to-all expert parallelism (see ``moe_apply``): x (B, S, d) with
    B sharded over the data axes and S over "model" (the sequence-sharded
    residual), flattened on the local shard. Each rank routes its tokens,
    sends each kept (token, k) slot to its expert's owner rank (at most
    c_send a destination, in slot order), computes its expert slice on
    what arrived (at most c_exp an expert, in arrival order; ids -1 mark
    empty rows), and a second all-to-all brings the results home. The
    router aux is averaged over every rank of the mesh. ``slots`` (a dict) receives
    this rank's ``keep`` and ``keep2`` masks."""
    ms = ctx.model_size
    e_num = cfg.n_experts // ms
    k = cfg.n_experts_per_tok
    mgroup = ctx.mesh.get_group(ctx.model_axis)
    # the mesh's own ranks: "model", then the data axes minor to major
    groups = tuple(ctx.mesh.get_group(a)
                   for a in (ctx.model_axis,) + tuple(ctx.data_axes)[::-1])
    n_all = ctx.data_size * ms

    def local(x_l, router, we_g, we_u, we_d):
        B_l, S_l, d = x_l.shape
        T_l = B_l * S_l
        xt = x_l.reshape(T_l, d)
        gate, idx, aux = _moe_route(xt, router, cfg)
        aux = _RankSum.apply(aux, groups, True) / n_all

        # ---- send side: group the (token, k) slots by owner rank -------
        c_send = max(int(cfg.capacity_factor * T_l * k / ms), 4)
        a = idx.reshape(T_l * k)
        g = gate.reshape(T_l * k).to(xt.dtype)
        dst = a // e_num                                  # owner rank
        eid = a - dst * e_num                             # expert there
        slot = _running_count(dst)
        keep = slot < c_send
        tgt = torch.where(keep, dst * c_send + slot, ms * c_send)
        rows = xt[:, None, :].expand(T_l, k, d).reshape(T_l * k, d)
        send_x = xt.new_zeros((ms * c_send + 1, d)).index_put((tgt,), rows)
        send_e = torch.full((ms * c_send + 1,), -1, dtype=torch.int32,
                            device=xt.device).index_put(
            (tgt,), torch.where(keep, eid, -1).to(torch.int32))

        # ---- exchange: row block r goes to rank r ----------------------
        recv_x = _all_to_all(send_x[:-1], mgroup)
        recv_e = _all_to_all(send_e[:-1], mgroup, grad=False)

        # ---- receive side: dispatch to the local experts ---------------
        c_exp = max(int(cfg.capacity_factor * T_l * k / e_num), 4)
        valid = recv_e >= 0
        e_loc = torch.where(valid, recv_e, e_num)
        slot2 = _running_count(e_loc)
        keep2 = valid & (slot2 < c_exp)
        tgt2 = torch.where(keep2, e_loc * c_exp + slot2, e_num * c_exp)
        xin = xt.new_zeros((e_num * c_exp + 1, d)).index_put((tgt2,), recv_x)
        xin = xin[:-1].reshape(e_num, c_exp, d)
        h = F.silu(torch.bmm(xin, we_g)) * torch.bmm(xin, we_u)
        y_e = torch.bmm(h, we_d)

        # ---- inverse path ------------------------------------------------
        y_flat = torch.cat([y_e.reshape(e_num * c_exp, d),
                            xt.new_zeros((1, d))])
        y_rows = _all_to_all(y_flat[tgt2], mgroup)
        safe = torch.where(keep, tgt, 0)
        w = (g * keep.to(g.dtype)).reshape(T_l, k, 1)
        y = y_rows[safe].reshape(T_l, k, d) * w
        out = y[:, 0]
        for j in range(1, k):
            out = out + y[:, j]
        if slots is not None:
            slots.update(keep=keep, keep2=keep2)
        return out.reshape(B_l, S_l, d), aux

    dp, m = ctx.data_spec_axes, ctx.model_axis
    ex = P(m, None, None)
    return local_region(local, ctx.mesh,
                        (P(dp, m, None), P(None, None), ex, ex, ex),
                        (P(dp, m, None), P()))(x3, *_experts(p))


def _moe_replicated_ep(xt, p, cfg: ArchConfig, ctx, data: bool = True):
    """Replicated-token expert parallelism, for few tokens (decode): every
    "model" rank routes the same tokens (sharded over the data axes, or
    whole with ``data=False``), computes its expert slice, and an
    all-reduce over "model" adds the slices; the aux is the mean over
    "model" (it differs between data shards, as in the JAX package, whose
    replicated output takes the first shard's)."""
    ms = ctx.model_size
    e_num = cfg.n_experts // ms
    mgroup = ctx.mesh.get_group(ctx.model_axis)
    m = ctx.model_axis

    def local(xt_l, router, we_g, we_u, we_d):
        rank = ctx.mesh.get_local_rank(m)
        p_l = {"router": router, "we_g": we_g, "we_u": we_u, "we_d": we_d}
        out, aux = _moe_local_dynamic(xt_l, p_l, cfg, rank * e_num, e_num)
        return (_RankSum.apply(out, (mgroup,), False),
                _RankSum.apply(aux, (mgroup,), True) / ms)

    dp = ctx.data_spec_axes if data else None
    ex = P(m, None, None)
    return local_region(local, ctx.mesh,
                        (P(dp, None), P(None, None), ex, ex, ex),
                        (P(dp, None), P()))(xt, *_experts(p))


def _moe_local_gathered(xt, p, cfg: ArchConfig, ctx):
    """The single-device MoE of few tokens that the data axes do not
    divide (B=1 long-context decode) under a mesh: every rank holds the
    tokens whole; experts sharded over "model" compute their slice and an
    all-reduce adds them (the JAX package leaves GSPMD to partition the
    expert matmuls over E), experts not sharded so are gathered."""
    if cfg.n_experts % ctx.model_size == 0:
        return _moe_replicated_ep(xt, p, cfg, ctx, data=False)
    rep = P(None, None, None)

    def local(xt_l, router, we_g, we_u, we_d):
        p_l = {"router": router, "we_g": we_g, "we_u": we_u, "we_d": we_d}
        return _moe_local(xt_l, p_l, cfg, 0, cfg.n_experts, 1)

    return local_region(local, ctx.mesh,
                        (P(None, None), P(None, None), rep, rep, rep),
                        (P(None, None), P()))(xt, *_experts(p))


def moe_apply(p, cfg: ArchConfig, x, ctx=None):
    """MoE FFN of x (B, S, d): (y, aux), the routed experts plus the
    shared ones.

    Distribution, in the JAX package's order:
      * mesh ctx with model_size > 1 and enough tokens (B divides over
        the data axes, S over "model", and each rank holds at least
        model_size tokens) -> all-to-all expert parallelism
        (``_moe_a2a``): tokens stay sharded over every mesh axis and only
        the slots move, two all-to-alls of (ranks, c_send, d) a layer;
      * mesh ctx whose data axes divide T -> replicated-token expert
        parallelism (``_moe_replicated_ep``);
      * mesh ctx otherwise (B=1 long-context decode) -> the local MoE on
        whole tokens, its expert matmuls split over "model";
      * no multi-device mesh -> the single-device capacity MoE.
    Plain tensors given under a mesh count as replicated; what comes
    back is then plain too."""
    B, S, d = x.shape
    T = B * S
    if not (has_mesh(ctx) and ctx.model_size > 1):
        out, aux = _moe_local(x.reshape(T, d), p, cfg, 0, cfg.n_experts, 1)
        return _shared(p, x, out.reshape(B, S, d), aux)
    if not is_dtensor(x):
        from repro_torch.nn.pytree import tree_map
        y, aux = moe_apply(tree_map(lambda t: _replicated(t, ctx.mesh), p),
                           cfg, _replicated(x, ctx.mesh), ctx)
        return y.full_tensor(), aux.full_tensor()
    ds, ms = ctx.data_size, ctx.model_size
    if B % ds == 0 and S % ms == 0 and T // (ds * ms) >= ms:
        y, aux = _moe_a2a(x, p, cfg, ctx)
    else:
        dp = ctx.data_spec_axes if B % ds == 0 else None
        xt = constrain(x, P(dp, None, None), ctx).reshape(T, d)
        if T % ds == 0:
            out, aux = _moe_replicated_ep(xt, p, cfg, ctx)
        else:
            out, aux = _moe_local_gathered(xt, p, cfg, ctx)
        y = out.reshape(B, S, d)
    return _shared(p, x, y, aux)


def _shared(p, x, y, aux):
    if "shared" in p:
        y = y + ffn_apply(p["shared"], x)
    return y, aux


# =========================================================================
# Mamba-2 (SSD) block
# =========================================================================

def ssm_init(key, cfg: ArchConfig, L: int | None, dtype):
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    G, N, dc = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_dconv
    pre = _pre(L)
    ks = prng.split(key, 8)
    dev = key.device
    # A init in [1, 16) as in mamba2; dt_bias from inv-softplus of U(1e-3, 0.1)
    a0 = uniform_init(ks[5], pre + (nh,), 1.0, 16.0)
    dt0 = uniform_init(ks[6], pre + (nh,), 1e-3, 0.1)
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    return {
        "wx": scaled_init(ks[0], pre + (d, di), dtype),
        "wz": scaled_init(ks[1], pre + (d, di), dtype),
        "wB": scaled_init(ks[2], pre + (d, G * N), dtype),
        "wC": scaled_init(ks[3], pre + (d, G * N), dtype),
        "wdt": scaled_init(ks[4], pre + (d, nh), dtype),
        "dt_bias": dt_bias.to(_F32),
        "A_log": torch.log(a0).to(_F32),
        "D": torch.ones(pre + (nh,), dtype=_F32, device=dev),
        "gnorm": torch.ones(pre + (di,), dtype=dtype, device=dev),
        "wo": scaled_init(ks[7], pre + (di, d), dtype),
        "conv_w": normal_init(ks[7], pre + (dc, cfg.conv_dim),
                              stddev=1.0 / math.sqrt(dc)).to(dtype),
        "conv_b": torch.zeros(pre + (cfg.conv_dim,), dtype=dtype,
                              device=dev),
    }


def _segsum(x):
    """(..., l) -> (..., l, l) cumulative segment sums, lower triangular,
    in x's dtype from a float64 cumulative sum (see ``ssd_ref``)."""
    l = x.shape[-1]
    cs = torch.cumsum(x.double(), dim=-1)
    seg = (cs[..., :, None] - cs[..., None, :]).to(x.dtype)
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return seg.masked_fill(~mask, float("-inf"))


def ssd_ref(xh, dt, A, Bv, Cv, chunk: int = 128, init_state=None):
    """Chunked SSD (state-space duality) forward — the plain version.

    xh (b,s,h,p); dt (b,s,h) (post-softplus); A (h,) negative; Bv/Cv
    (b,s,g,n). Returns (y (b,s,h,p), final_state (b,h,p,n)). All math
    fp32 except the cumulative sums of dA, which are float64: a decay
    exp(cs_l - cs_s) near the diagonal is the difference of two sums of up
    to 128 steps, and in float32 that cancellation alone puts ~1e-5 on y
    (the JAX package's float32 ``_segsum`` carries it). The CUDA kernel
    sums the same way.
    """
    b, s, h, pdim = xh.shape
    g, n = Bv.shape[2], Bv.shape[3]
    rep = h // g
    c = chunk_len(s, chunk)
    nc = s // c

    xf = xh.to(_F32).reshape(b, nc, c, h, pdim)
    dtf = dt.to(_F32).reshape(b, nc, c, h)
    Bh = Bv.to(_F32).reshape(b, nc, c, g, n).repeat_interleave(rep, dim=3)
    Ch = Cv.to(_F32).reshape(b, nc, c, g, n).repeat_interleave(rep, dim=3)

    dA = dtf * A[None, None, None, :]           # (b,nc,c,h) negative
    dA_cs = torch.cumsum(dA.double(), dim=2)    # float64, see above

    # intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(dA.movedim(3, 2)))               # (b,nc,h,c,c)
    scores = torch.einsum("bzlhn,bzshn->bzhls", Ch, Bh)       # (b,nc,h,c,c)
    y_diag = torch.einsum("bzhls,bzhls,bzsh,bzshp->bzlhp",
                          scores, Lmat, dtf, xf)

    # chunk states
    decay_states = torch.exp((dA_cs[:, :, -1:, :] - dA_cs).to(_F32))
    states = torch.einsum("bzlhn,bzlh,bzlh,bzlhp->bzhpn",
                          Bh, decay_states, dtf, xf)           # (b,nc,h,p,n)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(dA_cs[:, :, -1, :].to(_F32))       # (b,nc,h)
    carry = (torch.zeros((b, h, pdim, n), dtype=_F32, device=xh.device)
             if init_state is None else init_state.to(_F32))
    prev = []
    for z in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, z, :, None, None] + states[:, z]
    prev_states = torch.stack(prev, dim=1)                     # (b,nc,h,p,n)

    # off-diagonal contribution
    state_decay = torch.exp(dA_cs.to(_F32))                    # (b,nc,c,h)
    y_off = torch.einsum("bzlhn,bzlh,bzhpn->bzlhp",
                         Ch, state_decay, prev_states)

    y = (y_diag + y_off).reshape(b, s, h, pdim)
    return y.to(xh.dtype), carry


def _causal_conv(u, w, b):
    """Depthwise causal conv. u (B,S,C); w (K,C); b (C,)."""
    K = w.shape[0]
    S = u.shape[1]
    pad = torch.nn.functional.pad(u, (0, 0, K - 1, 0))
    # sum over taps: y[t] = sum_k w[k] * u[t - (K-1) + k]
    y = torch.zeros(u.shape, dtype=_F32, device=u.device)
    for k in range(K):
        y = y + pad[:, k:k + S, :].to(_F32) * w[k].to(_F32)
    return (y + b.to(_F32)).to(u.dtype)


def _ssd_local(scan, xh, dt, A, Bv, Cv, chunk: int):
    """Kernel #7 on DTensors: each rank's local batch and SSD heads (the
    B/C groups with them where there are several), the sequence whole.
    Returns y."""
    G = Bv.shape[2]
    b, h = _mesh_specs(xh.device_mesh, xh.shape[0],
                       (xh.shape[2],) + ((G,) if G > 1 else ()))
    g = h if G > 1 else None
    return local_region(
        lambda *a: scan(*a, chunk=chunk)[0], xh.device_mesh,
        (P(b, None, h, None), P(b, None, h), P(h), P(b, None, g, None),
         P(b, None, g, None)), P(b, None, h, None))(xh, dt, A, Bv, Cv)


def ssm_apply(p, cfg: ArchConfig, x, *, chunk: int = 128, ssd_fn=None):
    """Full-sequence Mamba-2 mixer (training / prefill), the scan through
    ``kernels.ssd_scan``, or through ``ssd_fn`` where one is given (for
    instance ``ssd_ref``), called as the scan is."""
    x = whole_dim(x)
    B, S, d = x.shape
    nh, hd = cfg.ssm_nheads, cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    z = x @ p["wz"]
    xin = x @ p["wx"]
    Bv = x @ p["wB"]
    Cv = x @ p["wC"]
    dt = softplus((x @ p["wdt"]).to(_F32) + p["dt_bias"])

    u = torch.cat([xin, Bv, Cv], dim=-1)
    u = _causal_conv(u, p["conv_w"], p["conv_b"])
    u = F.silu(u.to(_F32)).to(x.dtype)
    xin = u[..., :cfg.d_inner]
    Bv = u[..., cfg.d_inner:cfg.d_inner + G * N].reshape(B, S, G, N)
    Cv = u[..., cfg.d_inner + G * N:].reshape(B, S, G, N)

    A = -torch.exp(p["A_log"])
    xh = xin.reshape(B, S, nh, hd)
    scan = ssd_fn or ssd_scan
    if is_dtensor(xh):
        y = _ssd_local(scan, xh, dt, A, Bv, Cv, chunk)
    else:
        y, _ = scan(xh, dt, A, Bv, Cv, chunk=chunk)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(B, S, cfg.d_inner)
    y = rms_norm(y * F.silu(z.to(_F32)).to(y.dtype), p["gnorm"],
                 cfg.norm_eps)
    return whole_grad(y @ p["wo"])


def ssm_cache_init(cfg: ArchConfig, L: int | None, batch: int, dtype,
                   device) -> dict:
    nh, hd, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    pre = _pre(L)
    return {
        "state": torch.zeros(pre + (batch, nh, hd, N), dtype=_F32,
                             device=device),
        "conv": torch.zeros(pre + (batch, cfg.ssm_dconv - 1, cfg.conv_dim),
                            dtype=dtype, device=device),
    }


def ssm_decode(p, cfg: ArchConfig, x, cache):
    """Single-token recurrent SSD step. x (B,1,d)."""
    B = x.shape[0]
    nh, hd = cfg.ssm_nheads, cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    xt = x[:, 0]
    z = xt @ p["wz"]
    xin = xt @ p["wx"]
    Bv = xt @ p["wB"]
    Cv = xt @ p["wC"]
    dt = softplus((xt @ p["wdt"]).to(_F32) + p["dt_bias"])    # (B, nh)

    u = torch.cat([xin, Bv, Cv], dim=-1)                       # (B, conv_dim)
    hist = torch.cat([cache["conv"], u[:, None]], dim=1)       # (B, K, C)
    uc = (torch.einsum("bkc,kc->bc", hist.to(_F32), p["conv_w"].to(_F32))
          + p["conv_b"].to(_F32))
    uc = F.silu(uc).to(x.dtype)
    new_conv = hist[:, 1:]

    xin = uc[:, :cfg.d_inner]
    Bv = uc[:, cfg.d_inner:cfg.d_inner + G * N].reshape(B, G, N)
    Cv = uc[:, cfg.d_inner + G * N:].reshape(B, G, N)
    rep = nh // G
    Bh = Bv.repeat_interleave(rep, dim=1)                      # (B, nh, N)
    Ch = Cv.repeat_interleave(rep, dim=1)

    A = -torch.exp(p["A_log"])                                 # (nh,)
    xh = xin.reshape(B, nh, hd).to(_F32)
    dA = torch.exp(dt * A[None, :])                            # (B, nh)
    state = (cache["state"] * dA[:, :, None, None]
             + (dt[:, :, None] * xh)[..., None] * Bh[:, :, None, :].to(_F32))
    y = torch.einsum("bhpn,bhn->bhp", state, Ch.to(_F32))
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(B, cfg.d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(_F32)).to(y.dtype), p["gnorm"],
                 cfg.norm_eps)
    out = (y @ p["wo"])[:, None, :]
    return out, {"state": state, "conv": new_conv}
