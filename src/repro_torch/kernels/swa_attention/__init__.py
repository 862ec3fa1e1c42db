"""Sliding-window causal attention: CUDA kernel, plain version, wrapper."""
from repro_torch.kernels.swa_attention.ops import (
    swa_attention, swa_attention_plain,
)
from repro_torch.kernels.swa_attention.ref import swa_attention_ref

__all__ = ["swa_attention", "swa_attention_plain", "swa_attention_ref"]
