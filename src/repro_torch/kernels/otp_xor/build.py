"""Build and bind the otp_xor CUDA kernel (see ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as kbuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "otp_xor.cu"


def build() -> Path:
    """Compile the kernel library unless a build of this source exists."""
    return kbuild.build(SOURCE)[0]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = kbuild.load(SOURCE)
    fn = lib.otp_xor_mac
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_uint, ctypes.c_uint]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.otp_xor_mac_seeded
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint,
                    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint]
                   + [ctypes.c_void_p] * 3
                   + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    lib.otp_xor_mac_words_per_block.restype = ctypes.c_int
    lib.otp_xor_mac_max_leaves.restype = ctypes.c_int
    return lib
