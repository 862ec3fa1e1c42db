"""The SSD chunked scan in model layout (port of ``repro.kernels.ssd_scan.ops``).

``ssd_scan(xh, dt, A, Bv, Cv, chunk, init_state)`` is the drop-in for
``blocks.ssd_ref``: xh (B, S, H, P), dt (B, S, H), A (H,), Bv/Cv
(B, S, G, N) and an optional initial state (B, H, P, N) -> (y (B, S, H, P)
in xh's dtype, final state (B, H, P, N) float32). The chunk is the
largest divisor of S not above ``chunk``, the rule of the JAX package; it
changes rounding, not the function.

On a CUDA tensor it launches the hand-written kernel (``csrc/ssd_scan.cu``:
one launch over a (batch, head, chunk) grid, the carries passed between
chunks through a scratch buffer) and counts the launch in ``LAUNCHES``;
on a CPU tensor it runs the plain version, ``blocks.ssd_ref``. A CUDA
tensor never falls back to the plain version: the kernel runs or the
call raises. A given ``init_state`` is loaded by the kernel in place of
the zero state of a prefill (the JAX package sends it through its
reference instead). The kernel sums each chunk's incoming carry in a
fixed order, so calls on the same inputs give the same bits.

The backward replays the plain version, ``blocks.ssd_ref``, under
autograd, as the JAX package's ``_bwd`` replays its reference.
"""
from __future__ import annotations

import torch

#: the kernel's longest chunk (its float64 scan of dA holds 4 steps a lane)
MAX_CHUNK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of the CUDA kernel in this process (the wrapper adds one per
#: launch; callers reset it to 0 to count the launches of one run)
LAUNCHES = 0


def chunk_len(S: int, chunk: int) -> int:
    """The largest divisor of S that is at most ``chunk``."""
    c = min(chunk, S)
    while S % c != 0:
        c -= 1
    return c


def _launch(xh, dt, A, Bv, Cv, init_state, chunk: int):
    global LAUNCHES
    from repro_torch.kernels.ssd_scan.build import library

    B, S, H, P = xh.shape
    G, N = Bv.shape[2], Bv.shape[3]
    y = torch.empty_like(xh)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=xh.device)
    # the look-back's scratch, per (batch, head, chunk) block: its own end
    # state, the carry leaving it and its decay; a flag per block and the
    # block ticket (the kernel zeroes them on the stream)
    nb = B * H * (S // chunk)
    scratch = torch.empty(nb * (2 * P * N + 1), dtype=torch.float32,
                          device=xh.device)
    flags = torch.empty(nb + 1, dtype=torch.int32, device=xh.device)
    err = library().ssd_scan_fwd(
        xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bv.data_ptr(),
        Cv.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), scratch.data_ptr(), flags.data_ptr(),
        B, S, H, G, P, N, chunk,
        _DTYPES[xh.dtype],
        torch.cuda.current_stream(xh.device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssd_scan launch failed: CUDA error {err} at B={B}, S={S}, "
            f"H={H}, P={P}, G={G}, N={N}, chunk={chunk}, {xh.dtype}")
    LAUNCHES += 1
    return y, state


def _check(xh, dt, A, Bv, Cv, init_state, chunk: int):
    if xh.dim() != 4 or Bv.dim() != 4 or Bv.shape != Cv.shape:
        raise ValueError(f"xh must be (B, S, H, P) and Bv, Cv one "
                         f"(B, S, G, N), got {tuple(xh.shape)}, "
                         f"{tuple(Bv.shape)}, {tuple(Cv.shape)}")
    B, S, H, P = xh.shape
    G = Bv.shape[2]
    if (dt.shape != (B, S, H) or A.shape != (H,) or Bv.shape[:2] != (B, S)
            or G < 1 or H % G):
        raise ValueError(f"dt {tuple(dt.shape)}, A {tuple(A.shape)}, Bv "
                         f"{tuple(Bv.shape)} do not serve xh "
                         f"{tuple(xh.shape)} (H must be a multiple of G)")
    if init_state is not None and init_state.shape != (B, H, P, Bv.shape[3]):
        raise ValueError(f"init_state {tuple(init_state.shape)} is not "
                         f"(B, H, P, N) for xh {tuple(xh.shape)}, Bv "
                         f"{tuple(Bv.shape)}")
    for t in (dt, A, Bv, Cv, init_state):
        if t is not None and t.device != xh.device:
            raise ValueError("ssd_scan inputs must share one device")
    if xh.is_cuda:
        if (xh.dtype not in _DTYPES or Bv.dtype != xh.dtype
                or Cv.dtype != xh.dtype or P % 2 or chunk > MAX_CHUNK):
            raise ValueError(
                f"the ssd_scan kernel takes xh, Bv, Cv of one dtype "
                f"(float32 or bfloat16), an even head dim and chunks of at "
                f"most {MAX_CHUNK}, got {xh.dtype}/{Bv.dtype}/{Cv.dtype} "
                f"at xh {tuple(xh.shape)}, Bv {tuple(Bv.shape)}, "
                f"chunk {chunk}")
    elif xh.device.type not in ("cpu", "meta"):
        # meta: the dry-run's shape-only trace of the plain version
        raise ValueError(f"no ssd_scan for device {xh.device}")


class _SSDScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, dt, A, Bv, Cv, init_state, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(xh, dt, A, Bv, Cv, init_state)
        if xh.is_cuda:
            f32 = lambda t: t.float().contiguous()
            return _launch(xh.contiguous(), f32(dt), f32(A), Bv.contiguous(),
                           Cv.contiguous(),
                           None if init_state is None else f32(init_state),
                           chunk)
        from repro_torch.models.blocks import ssd_ref
        return ssd_ref(xh, dt, A, Bv, Cv, chunk=chunk, init_state=init_state)

    @staticmethod
    def backward(ctx, g_y, g_state):
        from repro_torch.models.blocks import ssd_ref

        inputs = [None if x is None else x.detach().requires_grad_(need)
                  for x, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        wanted = [x for x in inputs if x is not None and x.requires_grad]
        with torch.enable_grad():
            y, state = ssd_ref(*inputs[:5], chunk=ctx.chunk,
                               init_state=inputs[5])
            grads = iter(torch.autograd.grad((y, state), wanted,
                                             (g_y, g_state),
                                             allow_unused=True))
        return tuple(next(grads) if x is not None and x.requires_grad
                     else None for x in inputs) + (None,)


def ssd_scan(xh, dt, A, Bv, Cv, chunk: int = 128, init_state=None):
    """Model-layout drop-in for ``blocks.ssd_ref`` (see the module doc)."""
    c = chunk_len(xh.shape[1], chunk)
    _check(xh, dt, A, Bv, Cv, init_state, c)
    return _SSDScan.apply(xh, dt, A, Bv, Cv, init_state, c)
