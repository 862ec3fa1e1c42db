"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5, head_dim=64) d_ff=5504 vocab=32001,
ssm_state=16. Hymba runs attention and SSM heads in parallel in every
layer (outputs branch-normed then averaged) and uses sliding-window
attention except in three global layers (first / middle / last). The same
numbers as ``repro/configs/hymba_1_5b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32001,
    sliding_window=1024,
    global_attn_layers=(0, 15, 31),
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_dconv=4,
    rope_theta=10000.0,
)
