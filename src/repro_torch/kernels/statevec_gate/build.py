"""Build and bind the statevec_gate CUDA kernels (see ``kernels.build``)."""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

from repro_torch.kernels import build as kbuild

SOURCE = Path(__file__).resolve().parent / "csrc" / "statevec_gate.cu"

_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_LL = ctypes.c_longlong
_STREAM = ctypes.c_void_p
_PLANES = [_PTR] * 5          # re, im, gates, out_re, out_im
# entry -> its argument types
_SIGNATURES = {
    "statevec_gate_layer": _PLANES + [_LL, _INT, _INT, _INT, _STREAM],
    "statevec_gate_group": _PLANES + [_LL, _LL, _INT, _INT, _INT, _INT,
                                      _STREAM],
    "statevec_gate_1q": _PLANES + [_LL, _INT, _INT, _INT, _STREAM],
    # u_re, u_im, gates, v_re, v_im, out_re, out_im, partial
    "statevec_gate_layer_bwd": [_PTR] * 8 + [_LL, _LL] + [_INT] * 7
    + [_STREAM],
    "statevec_gate_grad_reduce": [_PTR, _PTR, _LL, _INT, _INT, _PTR,
                                  _STREAM],
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
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib
