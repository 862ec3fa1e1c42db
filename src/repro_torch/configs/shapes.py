"""The four assigned input shapes + per-shape config adaptation (a copy
of ``repro.configs.shapes``).

  train_4k     seq_len=4096    global_batch=256   (training)
  prefill_32k  seq_len=32768   global_batch=32    (inference-prefill)
  decode_32k   seq_len=32768   global_batch=128   (inference-decode)
  long_500k    seq_len=524288  global_batch=1     (long-context-decode)

Decode shapes lower ``serve_step`` (1 new token + cache of seq_len), not
``train_step``. ``long_500k`` requires sub-quadratic attention: SSM/hybrid
archs run natively; dense/moe/vlm archs run their sliding-window variant
(window below); whisper skips it (see DESIGN.md §Arch-applicability).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.config import ArchConfig

LONG_CTX_WINDOW = 4096   # sliding-window for dense archs at 500k context


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str                # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def shape_for(name: str) -> InputShape:
    return INPUT_SHAPES[name]


def needs_sliding_window(cfg: ArchConfig, shape: InputShape) -> bool:
    """Full attention over a 524288-token cache is not lowered; dense-ish
    archs switch to the ring-buffer sliding-window variant at long_500k."""
    if shape.name != "long_500k":
        return False
    if cfg.family in ("ssm",):
        return False                      # attention-free
    if cfg.sliding_window:
        return False                      # already sub-quadratic (hymba)
    return True


def supports_shape(cfg: ArchConfig, shape: InputShape) -> bool:
    # whisper: decoder context is bounded by the 30s audio window by
    # construction; a 500k transcript cache contradicts the architecture.
    if cfg.family == "encdec" and shape.name == "long_500k":
        return False
    return True


def cfg_for_shape(cfg: ArchConfig, shape_name: str) -> ArchConfig:
    """Adapt a config to an input shape (sliding-window variant at 500k)."""
    shape = shape_for(shape_name)
    if not supports_shape(cfg, shape):
        raise ValueError(f"{cfg.name} does not support {shape_name} "
                         f"(see DESIGN.md §Arch-applicability)")
    if needs_sliding_window(cfg, shape):
        return cfg.replace(sliding_window=LONG_CTX_WINDOW,
                           global_attn_layers=())
    return cfg
