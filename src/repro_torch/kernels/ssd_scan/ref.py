"""Plain PyTorch SSD scan in the kernel's head-major layout (port of
``repro.kernels.ssd_scan.ref``): a layout adapter over the model layer's
chunked reference, ``repro_torch.models.blocks.ssd_ref``."""
from __future__ import annotations


def ssd_scan_ref(x, dt, A, Bv, Cv, chunk: int = 128):
    """x (B, H, S, P), dt (B, H, S), A (H,), Bv/Cv (B, G, S, N) ->
    (y (B, H, S, P), state (B, H, P, N) float32)."""
    from repro_torch.models.blocks import ssd_ref

    y, st = ssd_ref(x.movedim(1, 2), dt.movedim(1, 2), A, Bv.movedim(1, 2),
                    Cv.movedim(1, 2), chunk=chunk)
    return y.movedim(2, 1), st
