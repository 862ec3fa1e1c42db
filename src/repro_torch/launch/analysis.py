"""Roofline analysis of the dry-run's traced steps (port of
``repro.launch.analysis``).

Three terms per (arch × shape × mesh), in seconds, with the constants of
one NVIDIA H100 80GB HBM3 SXM at its 700 W power limit (the card of the
port's measurements, ``nvidia-smi --query-gpu=name,power.limit``):

    compute    = FLOPs / (chips × 989e12)    (bf16 dense tensor-core peak)
    memory     = bytes / (chips × 3.35e12)   (HBM3 bandwidth)
    collective = collective_bytes_per_rank / 450e9   (one NVLink 4
                                                      direction)

The FLOP and byte terms are **analytic** (6·N_active·D plus attention and
SSM terms), copied formula for formula from the JAX package, so the two
give the same numbers for a combo. The collective term reads the
collectives the trace recorded on one rank (``collective_bytes``): eager
tracing runs every layer, so nothing needs expanding by trip counts. On
8-GPU H100 nodes a 16-wide "model" axis spans two nodes, whose link
(InfiniBand, ~50 GB/s a GPU) is slower than NVLink, so there the
collective term is a lower bound.

The traced FLOPs and bytes of the local ops one rank ran (``traced_flops``
from ``torch.utils.flop_counter``'s formulas, ``traced_bytes`` each op's
tensors read and written once, unfused) are kept in the record for
reference.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass, field

PEAK_FLOPS = 989e12         # bf16 dense / GPU (H100 SXM)
HBM_BW = 3.35e12            # bytes / s / GPU
LINK_BW = 450e9             # bytes / s, one NVLink 4 direction

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional-collective op name -> kind
_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "permute_tensor": "collective-permute",
}


def collective_kind(op_name: str):
    """The kind of a ``_c10d_functional`` (or its autograd twin's) op
    name such as ``all_gather_into_tensor.default``, or None."""
    return _KINDS.get(op_name.split(".")[0])


def collective_bytes(events) -> dict:
    """Per-kind collective bytes of one step on one rank from the
    ``(kind, result_bytes)`` events the trace recorded, plus ``count``:
    the JAX package's convention (the result's bytes on one rank)."""
    out = {k: 0 for k in COLLECTIVES}
    out["count"] = 0
    for kind, nbytes in events:
        out[kind] += int(nbytes)
        out["count"] += 1
    return out


# ---------------------------------------------------------------------------
# analytic FLOPs / bytes (global; divided by chips in the roofline terms)
# ---------------------------------------------------------------------------

def _param_counts(cfg, api):
    """(active_params, total_params, param_bytes) excluding embeddings,
    from the meta-tensor parameter tree."""
    from repro_torch.launch.steps import abstract_params
    from repro_torch.sharding.specs import map_with_path
    act = tot = byts = 0
    leaves = []
    map_with_path(lambda path, leaf: leaves.append((path, leaf)),
                  abstract_params(cfg, api))
    for path, leaf in leaves:
        names = [e for e in path if isinstance(e, str)]
        n = int(leaf.numel())
        byts += n * leaf.element_size()
        if "embed" in names or "pos_embed" in names:
            continue
        tot += n
        if any(nm in ("we_g", "we_u", "we_d") for nm in names):
            n = n * cfg.n_experts_per_tok // max(cfg.n_experts, 1)
        act += n
    return act, tot, byts


def _attn_layers(cfg) -> list:
    """Effective attention context multipliers per layer: (n_layers, window)."""
    if cfg.family == "ssm":
        return []
    wins = []
    for i in range(cfg.n_layers):
        w = 0
        if cfg.sliding_window and i not in cfg.global_attn_layers:
            w = cfg.sliding_window
        wins.append(w)
    return wins


def analytic_terms(cfg, api, shape) -> dict:
    """Global FLOPs and HBM bytes for one step of this (arch, shape)."""
    B, S = shape.global_batch, shape.seq_len
    act, tot, pbytes = _param_counts(cfg, api)
    H, hd = max(cfg.n_heads, 1), cfg.hd
    wins = _attn_layers(cfg)

    def attn_flops(q_len, ctx_avg):
        # scores + mix: 2 matmuls, 2 flops/MAC
        per_layer = 4.0 * B * q_len * ctx_avg * H * hd
        return sum(per_layer for _ in wins)

    def ssm_flops(q_len):
        if cfg.family not in ("ssm", "hybrid"):
            return 0.0
        nh, P, N = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
        # state update + readout per token per layer
        per_layer = 6.0 * B * q_len * nh * P * N
        return per_layer * cfg.n_layers

    if shape.mode == "train":
        D = B * S
        flops = 6.0 * act * D + 3.0 * (attn_flops(S, S / 2) + ssm_flops(S))
        # bytes: params read fwd+remat-fwd+bwd + grad write/read + update ~ 6x
        # + saved residuals (2 per layer) read+write + logits fp32 x3
        resid = 2 * D * cfg.d_model * 2 * max(cfg.n_layers, 1) * 2
        logits = 3 * D * cfg.padded_vocab * 4 if cfg.padded_vocab else 0
        byts = 6.0 * pbytes + resid + logits
    elif shape.mode == "prefill":
        D = B * S
        flops = 2.0 * act * D + attn_flops(S, S / 2) + ssm_flops(S)
        byts = pbytes + 2 * D * cfg.d_model * 2 * max(cfg.n_layers, 1)
    else:  # decode: one token, full cache context
        D = B
        ctxs = [min(w, S) if w > 0 else S for w in wins]
        aflops = sum(4.0 * B * 1 * c * H * hd for c in ctxs)
        flops = 2.0 * act * D + aflops + ssm_flops(1)
        kv_elt = 1.03 if cfg.kv_cache_dtype == "int8" else 2  # + fp16 scales
        kv_bytes = sum(2 * B * c * max(cfg.n_kv_heads, 1) * hd * kv_elt
                       for c in ctxs)
        ssm_bytes = (B * cfg.ssm_nheads * cfg.ssm_headdim * cfg.ssm_state * 4
                     * 2 * cfg.n_layers if cfg.family in ("ssm", "hybrid")
                     else 0)
        byts = pbytes + kv_bytes + ssm_bytes
    return {"flops": flops, "bytes": byts, "active_params": act,
            "total_params": tot, "param_bytes": pbytes}


def analytic_memory_per_chip(cfg, api, shape, n_chips: int, model_size: int,
                             data_size: int, fsdp: bool,
                             seq_shard: bool = True) -> dict:
    """Per-chip memory estimate of one step (bytes): the sharded
    parameters, plus gradients, saved residuals, attention and
    cross-entropy transients and the embedding gradient in training, the
    activations and attention buffer in prefill, the cache in decode.
    The dry-run's fits gate reads it against ``HBM_PER_CHIP``; the traced
    per-rank peak is recorded beside it."""
    B, S = shape.global_batch, shape.seq_len
    act, tot, pbytes = _param_counts(cfg, api)
    p_shard = model_size * (data_size if fsdp else 1)
    params = pbytes / p_shard
    d = max(cfg.d_model, 1)
    dp = data_size
    out = {"params": params}
    if shape.mode == "train":
        out["grads"] = params
        # saved residual stream per layer (bf16), seq-sharded over model
        seq_div = model_size if seq_shard else 1
        B_loc = max(B // dp, 1)
        out["saves"] = (cfg.n_layers * B_loc * S * d * 2) / seq_div
        # transient attention probs (bf16, 2 live) for one layer
        H = max(cfg.n_heads, 1)
        Sq = S / seq_div
        win = cfg.sliding_window or S
        out["attn_tmp"] = 2 * B_loc * H * Sq * min(win, S) * 2 / \
            (1 if seq_shard else model_size)
        # CE chunk logits (f32 + bf16) over sharded vocab
        out["ce_tmp"] = B_loc * min(1024, S) * cfg.padded_vocab * 6 / \
            max(model_size, 1) if cfg.padded_vocab else 0
        # embedding gradient (f32, vocab-sharded)
        out["embed_grad"] = (cfg.padded_vocab * d * 4 / model_size
                             if cfg.padded_vocab else 0)
    elif shape.mode == "prefill":
        B_loc = max(B // dp, 1)
        out["acts"] = 2 * B_loc * S * d * 2 / max(model_size, 1)
        H = max(cfg.n_heads, 1)
        # > QCHUNK_THRESHOLD sequences use query-chunked attention: the
        # quadratic buffer shrinks to (chunk × S) per head group
        sq_eff = 512 if S > 8192 else S / max(model_size, 1)
        h_eff = H / max(model_size, 1) if S > 8192 else H
        out["attn_tmp"] = 2 * B_loc * h_eff * sq_eff * min(
            cfg.sliding_window or S, S) * 2
    else:  # decode: dominated by the KV/SSM cache
        wins = _attn_layers(cfg)
        ctxs = [min(w, S) if w > 0 else S for w in wins]
        kv_elt = 1.03 if cfg.kv_cache_dtype == "int8" else 2
        kv = sum(2 * B * c * max(cfg.n_kv_heads, 1) * cfg.hd * kv_elt
                 for c in ctxs)
        ssm = (cfg.n_layers * B * cfg.ssm_nheads * cfg.ssm_headdim
               * cfg.ssm_state * 4 if cfg.family in ("ssm", "hybrid") else 0)
        # cache shards over batch (data axes) and kv-heads/context (model)
        out["cache"] = (kv + ssm) / (dp * model_size)
    out["total"] = float(sum(out.values()))
    return out


# ---------------------------------------------------------------------------
# the roofline record
# ---------------------------------------------------------------------------

@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_global: float
    bytes_global: float
    coll_bytes_per_device: float
    peak_memory_bytes: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    coll_breakdown: dict = field(default_factory=dict)
    traced_flops: float = 0.0
    traced_bytes: float = 0.0

    def to_dict(self):
        return asdict(self)


def analyze(arch: str, shape_name: str, mesh_name: str, n_chips: int,
            trace: dict, cfg, api, shape) -> Roofline:
    """The roofline record of one traced combo. ``trace`` holds the
    step's recorded ``collectives`` (``(kind, bytes)`` events), its
    ``traced_flops`` and ``traced_bytes`` and its traced per-rank
    ``peak_bytes`` (0 where none was measured)."""
    coll = collective_bytes(trace.get("collectives", ()))
    cbytes = float(sum(v for k, v in coll.items() if k != "count"))
    peak = float(trace.get("peak_bytes") or 0.0)

    terms = analytic_terms(cfg, api, shape)
    compute_s = terms["flops"] / (n_chips * PEAK_FLOPS)
    memory_s = terms["bytes"] / (n_chips * HBM_BW)
    collective_s = cbytes / LINK_BW
    tdict = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    dominant = max(tdict, key=tdict.get)

    # MODEL_FLOPS: 6·N_active·D (train) / 2·N_active·D (inference)
    mult = 6.0 if shape.mode == "train" else 2.0
    D = (shape.global_batch * shape.seq_len
         if shape.mode in ("train", "prefill") else shape.global_batch)
    model_flops = mult * terms["active_params"] * D
    useful = model_flops / max(terms["flops"], 1.0)

    return Roofline(arch, shape_name, mesh_name, terms["flops"],
                    terms["bytes"], cbytes, peak, compute_s, memory_s,
                    collective_s, dominant, model_flops, useful, coll,
                    float(trace.get("traced_flops", 0.0)),
                    float(trace.get("traced_bytes", 0.0)))


def format_roofline_row(r: Roofline) -> str:
    return (f"{r.arch:24s} {r.shape:12s} {r.mesh:6s} "
            f"C={r.compute_s*1e3:9.3f}ms M={r.memory_s*1e3:9.3f}ms "
            f"X={r.collective_s*1e3:9.3f}ms -> {r.dominant:10s} "
            f"useful={r.useful_ratio:6.3f} "
            f"peakHBM={r.peak_memory_bytes/2**30:7.2f}GiB")
