"""qwen3-0.6b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B family card].

28L d_model=1024 16H (GQA kv=8) d_ff=3072 vocab=151936. Qwen3 uses an
explicit head_dim=128 (projections widen to n_heads*128) and per-head
RMSNorm on q/k; embeddings tied at this scale.
The same numbers as ``repro/configs/qwen3_0_6b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
)
