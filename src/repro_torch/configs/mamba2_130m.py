"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

24L d_model=768 (attention-free) vocab=50280, ssm_state=128, expand=2
(d_inner=1536), headdim=64 (24 SSD heads), ngroups=1, d_conv=4.
The same numbers as ``repro/configs/mamba2_130m.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    n_layers=24,
    d_model=768,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_ngroups=1,
    ssm_dconv=4,
    tie_embeddings=True,
)
