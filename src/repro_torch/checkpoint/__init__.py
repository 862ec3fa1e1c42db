"""Round checkpoints of the port, in the JAX package's file format."""
from repro_torch.checkpoint.io import (
    CheckpointCorrupt, CheckpointManager, latest_step, load_checkpoint,
    read_leaves, read_metadata, save_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "read_metadata", "read_leaves", "CheckpointManager",
           "CheckpointCorrupt"]
