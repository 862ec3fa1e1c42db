"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].

94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936, MoE 128e
top-8, qk_norm, head_dim=128 (qwen3 style).
The same numbers as ``repro/configs/qwen3_moe_235b_a22b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    n_experts=128,
    n_experts_per_tok=8,
    moe_d_ff=1536,
    qk_norm=True,
    rope_theta=1000000.0,
)
