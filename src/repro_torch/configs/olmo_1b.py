"""olmo-1b [dense] — non-parametric LayerNorm [arXiv:2402.00838].

16L d_model=2048 16H (MHA kv=16) d_ff=8192 vocab=50304. OLMo uses
non-parametric LN (no scale/bias) and tied embeddings.
The same numbers as ``repro/configs/olmo_1b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=50304,
    norm_type="nonparam_ln",
    tie_embeddings=True,
    rope_theta=10000.0,
)
