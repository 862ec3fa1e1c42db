"""Model registry of the port (the paper's VQC so far)."""
from repro_torch.models.config import ArchConfig
from repro_torch.models.registry import (
    ModelApi, get_config, get_model, list_archs,
)

__all__ = ["ArchConfig", "ModelApi", "get_config", "get_model", "list_archs"]
