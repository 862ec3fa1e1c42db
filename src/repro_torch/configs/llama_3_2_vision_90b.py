"""llama-3.2-vision-90b [vlm] — cross-attn image layers
[hf:meta-llama/Llama-3.2-11B-Vision family card].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Every 5th layer
is a tanh-gated cross-attention layer over image tokens (20 cross + 80
self). The ViT/SigLIP encoder + projector is STUBBED: input_specs provides
(B, 1600, 8192) projected image-token embeddings (see DESIGN.md).
The same numbers as ``repro/configs/llama_3_2_vision_90b.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    cross_every=5,
    n_image_tokens=1600,
    vision_dim=8192,
    rope_theta=500000.0,
)
