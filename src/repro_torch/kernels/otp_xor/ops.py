"""Wrappers of the fused OTP-XOR + MAC kernel (port of
``repro.kernels.otp_xor.ops``).

Two entries mirror the two TPU functions, and tag the stream they are
given at its true length:

  * ``otp_xor_mac_rows`` — (E, n) rows, one grid row per edge (TPU kernel
    #4, ``otp_xor_mac_edge_blocks``): the trainer's secure stage;
  * ``otp_xor_mac_stream`` — one (n,) stream (TPU kernel #5,
    ``otp_xor_mac_blocks``): the per-edge oracle's exchange.

``otp_xor_mac_edges`` and ``otp_xor_mac`` mirror the JAX wrappers of the
same names: they zero-pad each stream to whole 16384-word blocks first,
because the JAX wrappers tag the padded stream (the block size is part of
that wire format). The trainer tags unpadded streams, as the JAX trainer's
``poly_mac_rows`` does; mixing the two conventions gives different tags.

Words are u32 values in int32 bit storage (``ref.as_storage`` /
``ref.as_words`` convert from and to int64 words). On a CUDA tensor an
entry launches the kernel and counts the launch in ``LAUNCHES``; on a CPU
tensor it runs the plain version in ``ref.py``. A CUDA tensor never falls
back to the plain version: the kernel runs or the call raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.otp_xor.ref import otp_xor_mac_rows_ref

#: launches of the CUDA kernel in this process, by entry (each entry adds
#: one per launch; callers reset them to 0 to count the launches of a run)
LAUNCHES = {"otp_xor_mac_edges": 0, "otp_xor_mac": 0}

#: the JAX wrappers' block: 128 rows x 128 lanes = 16384 words
DEFAULT_BLOCK_ROWS = 128
_LANES = 128
_MAX_ROWS = 65535          # one grid row per edge (gridDim.y)
_M32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=None)
def _words_per_block() -> int:
    from repro_torch.kernels.otp_xor.build import library
    return int(library().otp_xor_mac_words_per_block())


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(msg, pad, r_keys, s_keys, r_scalar, s_scalar, tag_input):
    from repro_torch.kernels.otp_xor.build import library

    E, n = msg.shape
    nblk = -(-n // _words_per_block())
    ct = torch.empty_like(msg)
    tags = torch.empty((E,), dtype=torch.int32, device=msg.device)
    scratch = (torch.empty((E * (nblk + 1),), dtype=torch.int32,
                           device=msg.device) if nblk > 1 else None)
    err = library().otp_xor_mac(
        msg.data_ptr(), pad.data_ptr(), _ptr(r_keys), _ptr(s_keys),
        r_scalar, s_scalar, ct.data_ptr(), tags.data_ptr(), _ptr(scratch),
        E, n, int(bool(tag_input)),
        torch.cuda.current_stream(msg.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"otp_xor_mac launch failed: CUDA error {err} "
                           f"at E={E}, n={n}")
    return ct, tags


def _check_words(msg, pad, ndim: int):
    if msg.dim() != ndim or msg.shape != pad.shape or msg.shape[-1] < 1:
        raise ValueError(f"msg and pad must be one {ndim}-d shape with at "
                         f"least one word, got {tuple(msg.shape)}, "
                         f"{tuple(pad.shape)}")
    for t in (msg, pad):
        if t.dtype != torch.int32 or t.device != msg.device:
            raise ValueError("msg and pad must be int32 bit storage of u32 "
                             "words on one device")
        if not t.is_contiguous():
            raise ValueError("msg and pad must be contiguous")
    if msg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no otp_xor_mac for device {msg.device}")


def otp_xor_mac_rows(msg: torch.Tensor, pad: torch.Tensor,
                     r_keys: torch.Tensor, s_keys: torch.Tensor,
                     tag_input: bool = False):
    """XOR and tag E rows: msg/pad (E, n) int32, MAC keys (E,) int32 ->
    (ct (E, n), tags (E,)), int32. Tags cover ``msg`` when ``tag_input``
    (the receiver tags what it received) and ``ct`` otherwise."""
    _check_words(msg, pad, 2)
    E = msg.shape[0]
    for t in (r_keys, s_keys):
        if (t.shape != (E,) or t.dtype != torch.int32
                or t.device != msg.device or not t.is_contiguous()):
            raise ValueError(f"MAC keys must be contiguous int32 ({E},) "
                             f"on {msg.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    if msg.device.type == "cpu":
        return otp_xor_mac_rows_ref(msg, pad, r_keys, s_keys, tag_input)
    if E > _MAX_ROWS:
        raise ValueError(f"{E} rows exceed the kernel's {_MAX_ROWS}")
    out = _launch(msg, pad, r_keys, s_keys, 0, 0, tag_input)
    LAUNCHES["otp_xor_mac_edges"] += 1
    return out


def otp_xor_mac_stream(msg: torch.Tensor, pad: torch.Tensor, r_key: int,
                       s_key: int, tag_input: bool = False):
    """XOR and tag one stream: msg/pad (n,) int32, keys as ints ->
    (ct (n,), tag 0-d), int32."""
    _check_words(msg, pad, 1)
    r_key, s_key = int(r_key) & _M32, int(s_key) & _M32
    if msg.device.type == "cpu":
        keys = torch.tensor([[r_key], [s_key]], dtype=torch.int64)
        ct, tags = otp_xor_mac_rows_ref(msg[None], pad[None], keys[0],
                                        keys[1], tag_input)
    else:
        ct, tags = _launch(msg[None], pad[None], None, None, r_key, s_key,
                           tag_input)
        LAUNCHES["otp_xor_mac"] += 1
    return ct[0], tags[0]


def _padded(x: torch.Tensor, block_rows: int) -> tuple:
    n = x.shape[-1]
    words = block_rows * _LANES
    nb = max(-(-n // words), 1)
    return F.pad(x, (0, nb * words - n)), n


def otp_xor_mac_edges(msgs: torch.Tensor, pads: torch.Tensor, r_keys,
                      s_keys, block_rows: int = DEFAULT_BLOCK_ROWS):
    """Edge-batched encrypt-and-tag in the JAX wrapper's convention: each
    row zero-padded to whole blocks and tagged over the padded stream.
    Returns (ct (E, n), tags (E,)), int32."""
    msg, n = _padded(msgs, block_rows)
    pad, _ = _padded(pads[:, :n], block_rows)
    ct, tags = otp_xor_mac_rows(msg, pad, r_keys, s_keys)
    return ct[:, :n], tags


def otp_xor_mac(msg: torch.Tensor, pad: torch.Tensor, r_key, s_key,
                block_rows: int = DEFAULT_BLOCK_ROWS):
    """Encrypt-and-tag one stream in the JAX wrapper's convention (padded
    stream tagged). Returns (ct (n,), tag 0-d), int32."""
    m, n = _padded(msg, block_rows)
    p, _ = _padded(pad[:n], block_rows)
    ct, tag = otp_xor_mac_stream(m, p, int(r_key), int(s_key))
    return ct[:n], tag
