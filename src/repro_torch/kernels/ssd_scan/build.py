"""Build and bind the ssd_scan CUDA kernel (see ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as kbuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "ssd_scan.cu"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = kbuild.load(SOURCE)
    fn = lib.ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib
