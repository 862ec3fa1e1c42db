"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks.

    ``None`` and ``"cuda"`` mean the GPU, and raise where CUDA is absent —
    the port never drops to the CPU on its own. Pass ``"cpu"`` (or a
    ``torch.device``) to choose explicitly.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, and no CUDA device is "
            "available here; pass device='cpu' to run on the CPU")
    return dev
