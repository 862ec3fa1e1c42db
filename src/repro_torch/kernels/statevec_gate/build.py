"""Build and bind the statevec_gate CUDA kernels (see ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as kbuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "statevec_gate.cu"

_PTRS = [ctypes.c_void_p] * 5
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_STREAM = ctypes.c_void_p
# entry -> its arguments after the five plane and gate pointers
_SIGNATURES = {
    "statevec_gate_layer": [_LL, _INT, _INT, _INT, _STREAM],
    "statevec_gate_group": [_LL, _LL, _INT, _INT, _INT, _INT, _STREAM],
    "statevec_gate_1q": [_LL, _INT, _INT, _INT, _STREAM],
}


def build() -> Path:
    """Compile the kernel library unless a build of this source exists."""
    return kbuild.build(SOURCE)[0]


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = kbuild.load(SOURCE)
    for name, args in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = _PTRS + args
        fn.restype = ctypes.c_int
    return lib
