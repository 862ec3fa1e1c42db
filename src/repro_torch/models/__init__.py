"""Model registry of the port: the paper's VQC, the decoders (dense, moe,
ssm, hybrid), the encoder-decoder and the VLM."""
from repro_torch.models.config import ArchConfig, smoke_variant
from repro_torch.models.registry import (
    ModelApi, get_config, get_model, list_archs,
)

__all__ = ["ArchConfig", "ModelApi", "get_config", "get_model", "list_archs",
           "smoke_variant"]
