"""whisper-tiny [audio] — enc-dec transformer backbone [arXiv:2212.04356].

4L encoder + 4L decoder, d_model=384 6H (MHA kv=6) d_ff=1536 vocab=51865.
The mel-spectrogram + conv frontend is STUBBED: input_specs provides
(B, 1500, 384) frame embeddings (see DESIGN.md). Decoder uses learned
positions (max 448, clamped beyond) and ties embed/unembed.
The same numbers as ``repro/configs/whisper_tiny.py``.
"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="encdec",
    n_layers=4,           # decoder layers
    n_enc_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    norm_type="layernorm",
    n_audio_frames=1500,
    max_decode_len=448,
    tie_embeddings=True,
)
