"""Optimizers and tree utilities of the port."""
from repro_torch.nn.optim import (
    OptState, Optimizer, adamw, constant_schedule, cosine_schedule,
    get_optimizer, inv_sqrt_schedule, momentum, sgd,
)
from repro_torch.nn.pytree import (
    tree_bytes, tree_leaves, tree_map, tree_weighted_sum,
)

__all__ = ["OptState", "Optimizer", "adamw", "constant_schedule",
           "cosine_schedule", "get_optimizer", "inv_sqrt_schedule",
           "momentum", "sgd", "tree_bytes", "tree_leaves", "tree_map",
           "tree_weighted_sum"]
