"""granite-34b [dense] — llama-arch, code, MQA [arXiv:2405.04324].

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
The same numbers as ``repro/configs/granite_34b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-34b",
    family="dense",
    n_layers=88,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    rope_theta=10000.0,
)
