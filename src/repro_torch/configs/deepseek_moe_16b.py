"""deepseek-moe-16b [moe] — fine-grained experts [arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=102400,
2 shared + 64 routed experts top-6; first layer is a dense FFN (10944).
The same numbers as ``repro/configs/deepseek_moe_16b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    n_experts=64,
    n_experts_per_tok=6,
    n_shared_experts=2,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,
    rope_theta=10000.0,
)
