"""Model configurations of the port (one module per arch id) + input shapes."""
from repro_torch.configs.shapes import INPUT_SHAPES, cfg_for_shape, shape_for

__all__ = ["INPUT_SHAPES", "shape_for", "cfg_for_shape"]
