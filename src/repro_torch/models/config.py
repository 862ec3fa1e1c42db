"""Architecture configuration (a copy of ``repro.models.config.ArchConfig``).

One frozen dataclass covers every model family; family-specific fields
default to "off". The port runs every family: the ``vqc``, the dense,
moe, ssm and hybrid decoders, the encoder-decoder and the VLM.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


def _pad_to(n: int, align: int = 128) -> int:
    return ((n + align - 1) // align) * align


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    vocab_size: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0                # 0 -> d_model // n_heads
    d_ff: int = 0

    # --- norm / attention variants -------------------------------------
    norm_type: str = "rmsnorm"       # rmsnorm | nonparam_ln | layernorm
    qk_norm: bool = False            # qwen3: per-head RMSNorm on q,k
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    sliding_window: int = 0          # 0 = full attention (training + serve)
    # layers (indices) that keep FULL attention when sliding_window > 0
    global_attn_layers: tuple = ()

    # --- MoE -------------------------------------------------------------
    n_experts: int = 0
    n_experts_per_tok: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden size
    first_dense_layers: int = 0      # deepseek-moe: leading dense layer(s)
    first_dense_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- SSM (mamba2 / hymba branch) --------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    ssm_dconv: int = 4

    # --- encoder-decoder (whisper) ----------------------------------------
    n_enc_layers: int = 0
    n_audio_frames: int = 1500       # stub frontend output length
    max_decode_len: int = 448        # learned decoder positions (see DESIGN)

    # --- VLM (llama-3.2-vision) -------------------------------------------
    cross_every: int = 0             # 1 cross-attn layer per `cross_every`
    n_image_tokens: int = 0
    vision_dim: int = 0              # stub projector output dim

    # --- VQC (the paper's own quantum model) --------------------------------
    vqc_qubits: int = 0
    vqc_layers: int = 0
    n_features: int = 0
    n_classes: int = 0

    # --- numerics ----------------------------------------------------------
    dtype: str = "bfloat16"
    kv_cache_dtype: str = "bfloat16"   # "int8": quantized KV cache (per-slot
                                       # per-head scales) — §Perf serving
                                       # lever: halves the decode memory term
    norm_eps: float = 1e-6

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a 128 multiple so the lm head shards over 16-way TP."""
        return _pad_to(self.vocab_size, 128)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_ngroups * self.ssm_state

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


def smoke_variant(cfg: ArchConfig) -> ArchConfig:
    """Reduced same-family variant for CPU smoke tests (the JAX package's
    ``smoke_variant``): 2 layers, d_model <= 256, <= 4 experts, small vocab."""
    kw: dict = dict(
        n_layers=2,
        d_model=min(cfg.d_model, 256),
        vocab_size=min(cfg.vocab_size, 512),
        dtype="float32",
    )
    if cfg.n_heads:
        kw["n_heads"] = min(cfg.n_heads, 4)
        kw["n_kv_heads"] = (min(cfg.n_kv_heads, 2)
                            if cfg.n_kv_heads < cfg.n_heads else kw["n_heads"])
        kw["head_dim"] = 32 if cfg.head_dim else 0
    if cfg.d_ff:
        kw["d_ff"] = min(cfg.d_ff, 512)
    if cfg.family == "moe":
        kw["n_experts"] = 4
        kw["n_experts_per_tok"] = 2
        kw["moe_d_ff"] = 128
        kw["first_dense_layers"] = min(cfg.first_dense_layers, 1)
        kw["first_dense_d_ff"] = 256 if cfg.first_dense_d_ff else 0
        kw["n_shared_experts"] = min(cfg.n_shared_experts, 1)
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm_state"] = min(cfg.ssm_state, 16)
        kw["ssm_headdim"] = 32
    if cfg.family == "encdec":
        kw["n_enc_layers"] = 2
        kw["n_audio_frames"] = 32
        kw["max_decode_len"] = 64
    if cfg.family == "vlm":
        kw["cross_every"] = 2
        kw["n_layers"] = 4              # 2 groups of (1 cross + 1 self)
        kw["n_image_tokens"] = 16
        kw["vision_dim"] = kw["d_model"]
    if cfg.sliding_window:
        kw["sliding_window"] = 16
        kw["global_attn_layers"] = (0,)
    return cfg.replace(**kw)
