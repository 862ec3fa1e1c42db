"""NN substrate of the port: functional layers, initializers, optimizers,
schedules and tree utilities."""
from repro_torch.nn.common import (
    apply_rope, count_params, gelu_mlp, layer_norm, rms_norm, rope_angles,
    softmax_cross_entropy, swiglu,
)
from repro_torch.nn.init import normal_init, ones_init, scaled_init, zeros_init
from repro_torch.nn.optim import (
    OptState, Optimizer, adamw, constant_schedule, cosine_schedule,
    get_optimizer, inv_sqrt_schedule, momentum, sgd,
)
from repro_torch.nn.pytree import (
    tree_add, tree_bytes, tree_cast, tree_flatten_to_vector, tree_leaves,
    tree_map, tree_scale, tree_size, tree_unflatten_from_vector,
    tree_weighted_sum, tree_zeros_like,
)

__all__ = ["rms_norm", "layer_norm", "apply_rope", "rope_angles", "swiglu",
           "gelu_mlp", "softmax_cross_entropy", "count_params",
           "normal_init", "scaled_init", "zeros_init", "ones_init",
           "OptState", "Optimizer", "adamw", "constant_schedule",
           "cosine_schedule", "get_optimizer", "inv_sqrt_schedule",
           "momentum", "sgd", "tree_size", "tree_bytes",
           "tree_flatten_to_vector", "tree_unflatten_from_vector",
           "tree_cast", "tree_zeros_like", "tree_add", "tree_scale",
           "tree_weighted_sum", "tree_leaves", "tree_map"]
