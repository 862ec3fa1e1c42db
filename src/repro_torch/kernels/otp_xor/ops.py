"""Wrappers of the fused OTP-XOR + MAC kernel (port of
``repro.kernels.otp_xor.ops``).

Two pairs of entries mirror the two TPU functions, and tag the stream they
are given at its true length. The seeded pair generates the pads inside the
kernel from 32-bit seeds and a pad layout (``security.otp.pad_layout``),
bit for bit what ``security.otp.encrypt_tree(_rows)`` XORs in; it is what
the trainer runs:

  * ``otp_xor_mac_rows_seeded`` — (E, n) rows, one grid row per edge (TPU
    kernel #4, ``otp_xor_mac_edge_blocks``): the trainer's secure stage;
  * ``otp_xor_mac_stream_seeded`` — one (n,) stream (TPU kernel #5,
    ``otp_xor_mac_blocks``): the per-edge oracle's exchange.

The given-pad pair, ``otp_xor_mac_rows`` and ``otp_xor_mac_stream``, takes
the pad words as a tensor.

``otp_xor_mac_edges`` and ``otp_xor_mac`` mirror the JAX wrappers of the
same names: they zero-pad each stream to whole 16384-word blocks first,
because the JAX wrappers tag the padded stream (the block size is part of
that wire format). The trainer tags unpadded streams, as the JAX trainer's
``poly_mac_rows`` does; mixing the two conventions gives different tags.

Words and seeds are u32 values in int32 bit storage (``ref.as_storage`` /
``ref.as_words`` convert from and to int64 words). On a CUDA tensor an
entry launches the kernel and counts the launch in ``LAUNCHES``, under its
own key; on a CPU tensor it runs the plain version in ``ref.py``. A CUDA
tensor never falls back to the plain version: the kernel runs or the call
raises.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels.otp_xor.ref import (otp_xor_mac_rows_ref,
                                             otp_xor_mac_rows_seeded_ref)
from repro_torch.security.otp import layout_rows

#: launches of the CUDA kernel in this process, by entry (each entry adds
#: one per launch; callers reset them to 0 to count the launches of a run):
#: the given-pad rows and stream entries, then the seeded ones
LAUNCHES = {"otp_xor_mac_edges": 0, "otp_xor_mac": 0,
            "otp_xor_mac_edges_seeded": 0, "otp_xor_mac_seeded": 0}

#: leaves the seeded body's shared key table holds (the kernel's
#: ``kMaxLeaves``; a larger layout raises on every device)
MAX_LEAVES = 512

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


def _launch(msg, pad, r_keys, s_keys, r_scalar, s_scalar, tag_input,
            seeds=None, seed_scalar=0, layout=None):
    """One launch over msg's (E, n) rows: the given-pad body, or the
    seeded body when a ``layout`` is given (per-row ``seeds``, or
    ``seed_scalar`` for every row)."""
    from repro_torch.kernels.otp_xor.build import library

    lib = library()
    E, n = msg.shape
    nblk = -(-n // _words_per_block())
    ct = torch.empty_like(msg)
    tags = torch.empty((E,), dtype=torch.int32, device=msg.device)
    scratch = (torch.empty((E * (nblk + 1),), dtype=torch.int32,
                           device=msg.device) if nblk > 1 else None)
    stream = torch.cuda.current_stream(msg.device).cuda_stream
    if layout is None:
        err = lib.otp_xor_mac(
            msg.data_ptr(), pad.data_ptr(), _ptr(r_keys), _ptr(s_keys),
            r_scalar, s_scalar, ct.data_ptr(), tags.data_ptr(),
            _ptr(scratch), E, n, int(bool(tag_input)), stream)
    else:
        err = lib.otp_xor_mac_seeded(
            msg.data_ptr(), _ptr(seeds), seed_scalar, layout.data_ptr(),
            layout.shape[0], _ptr(r_keys), _ptr(s_keys), r_scalar, s_scalar,
            ct.data_ptr(), tags.data_ptr(), _ptr(scratch), E, n,
            int(bool(tag_input)), stream)
    if err != 0:
        raise RuntimeError(f"otp_xor_mac launch failed: CUDA error {err} "
                           f"at E={E}, n={n}")
    return ct, tags


def _check_words(ndim: int, msg, pad=None):
    """msg (and pad, for the given-pad entries): one ``ndim``-d shape of
    at least one word, contiguous int32 storage on one device."""
    names = "msg" if pad is None else "msg and pad"
    arrays = (msg,) if pad is None else (msg, pad)
    if (msg.dim() != ndim or msg.shape[-1] < 1
            or any(t.shape != msg.shape for t in arrays)):
        raise ValueError(f"{names} must be one {ndim}-d shape with at "
                         f"least one word, got "
                         f"{[tuple(t.shape) for t in arrays]}")
    for t in arrays:
        if t.dtype != torch.int32 or t.device != msg.device:
            raise ValueError(f"{names} must be int32 bit storage of u32 "
                             f"words on one device")
        if not t.is_contiguous():
            raise ValueError(f"{names} must be contiguous")
    if msg.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no otp_xor_mac for device {msg.device}")


def _check_rows(msg, *row_arrays, what: str):
    """Per-row arrays (MAC keys, seeds): contiguous int32 (E,) on msg's
    device."""
    E = msg.shape[0]
    for t in row_arrays:
        if (t.shape != (E,) or t.dtype != torch.int32
                or t.device != msg.device or not t.is_contiguous()):
            raise ValueError(f"{what} must be contiguous int32 ({E},) on "
                             f"{msg.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _check_layout(layout, msg):
    """A pad layout the seeded body takes: int64 (L, 4), contiguous, on
    msg's device, 1 <= L <= MAX_LEAVES, leaves of width 32 or 16 tiling
    msg's n words in order, leaf indices u32."""
    if (not isinstance(layout, torch.Tensor) or layout.dtype != torch.int64
            or layout.dim() != 2 or layout.shape[1] != 4
            or layout.device != msg.device or not layout.is_contiguous()):
        raise ValueError(f"a pad layout must be a contiguous int64 (L, 4) "
                         f"tensor on {msg.device} (security.otp.pad_layout)")
    if not 1 <= layout.shape[0] <= MAX_LEAVES:
        raise ValueError(f"{layout.shape[0]} leaves: the seeded kernel's key "
                         f"table holds 1 to {MAX_LEAVES}")
    off = 0
    for i, first, count, width in layout_rows(layout):
        if (first != off or count < 0 or width not in (16, 32)
                or not 0 <= i <= _M32):
            raise ValueError(f"bad pad layout row {(i, first, count, width)}"
                             f" at word {off}")
        off += count if width == 32 else (count + 1) // 2
    if off != msg.shape[-1]:
        raise ValueError(f"the pad layout covers {off} words, the message "
                         f"{msg.shape[-1]}")


def otp_xor_mac_rows(msg: torch.Tensor, pad: torch.Tensor,
                     r_keys: torch.Tensor, s_keys: torch.Tensor,
                     tag_input: bool = False):
    """XOR and tag E rows: msg/pad (E, n) int32, MAC keys (E,) int32 ->
    (ct (E, n), tags (E,)), int32. Tags cover ``msg`` when ``tag_input``
    (the receiver tags what it received) and ``ct`` otherwise."""
    _check_words(2, msg, pad)
    E = msg.shape[0]
    _check_rows(msg, r_keys, s_keys, what="MAC keys")
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
    _check_words(1, msg, pad)
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


def otp_xor_mac_rows_seeded(msg: torch.Tensor, seeds: torch.Tensor,
                            layout: torch.Tensor, r_keys: torch.Tensor,
                            s_keys: torch.Tensor, tag_input: bool = False):
    """XOR and tag E rows with pads generated from their seeds: msg (E, n)
    int32, seeds and MAC keys (E,) int32 storage of u32, ``layout`` the pad
    layout of the rows' tree (``security.otp.pad_layout(tree, lead=1)``) ->
    (ct (E, n), tags (E,)), int32. Row e's pad is what
    ``encrypt_tree_rows`` XORs in under seeds[e]."""
    _check_words(2, msg)
    _check_rows(msg, seeds, what="seeds")
    _check_rows(msg, r_keys, s_keys, what="MAC keys")
    _check_layout(layout, msg)
    if msg.device.type == "cpu":
        return otp_xor_mac_rows_seeded_ref(msg, seeds, layout, r_keys,
                                           s_keys, tag_input)
    if msg.shape[0] > _MAX_ROWS:
        raise ValueError(f"{msg.shape[0]} rows exceed the kernel's "
                         f"{_MAX_ROWS}")
    out = _launch(msg, None, r_keys, s_keys, 0, 0, tag_input, seeds=seeds,
                  layout=layout)
    LAUNCHES["otp_xor_mac_edges_seeded"] += 1
    return out


def otp_xor_mac_stream_seeded(msg: torch.Tensor, seed: int,
                              layout: torch.Tensor, r_key: int, s_key: int,
                              tag_input: bool = False):
    """XOR and tag one stream with the pad generated from ``seed``: msg
    (n,) int32, seed and keys as ints, ``layout`` the tree's pad layout
    (``security.otp.pad_layout(tree)``) -> (ct (n,), tag 0-d), int32."""
    _check_words(1, msg)
    _check_layout(layout, msg)
    seed, r_key, s_key = (int(x) & _M32 for x in (seed, r_key, s_key))
    if msg.device.type == "cpu":
        row = torch.tensor([[seed], [r_key], [s_key]], dtype=torch.int64)
        ct, tags = otp_xor_mac_rows_seeded_ref(msg[None], row[0], layout,
                                               row[1], row[2], tag_input)
    else:
        ct, tags = _launch(msg[None], None, None, None, r_key, s_key,
                           tag_input, seed_scalar=seed, layout=layout)
        LAUNCHES["otp_xor_mac_seeded"] += 1
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
