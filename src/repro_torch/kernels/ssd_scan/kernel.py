"""Launcher for the CUDA Mamba-2 SSD chunked scan (``csrc/ssd_scan.cu``).

The GPU counterpart of the TPU kernel
``repro/kernels/ssd_scan/kernel.py::ssd_scan``: per (sequence, head), the
chunk's attention-duality products with the causal segment decay, and an
f32 (P, N) state carried across the chunks. One launch runs four CUDA
kernels on the stream, the chunks in parallel and only the state pass in
order: each chunk's ``C Bᵀ`` (once for all heads), each chunk's state,
the pass that carries the state across chunks, and each chunk's output,
through f32 scratch the wrapper allocates. Unlike the TPU kernel it
starts from an optional
initial state and returns the final one (a prefill into a Mamba cache
needs both), and it reads the model's layout directly: xt (B, L, H, P)
and da (B, L, H) contiguous, and Bm, Cm (B, L, N) **by stride** — they
are slices of the conv output ``xbc``, read in place with their batch
and position strides (unit stride over N), never copied or repeated per
head. The library is built with ``nvcc`` at first launch and bound with
``ctypes``; nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, counters

SOURCE = "ssd_scan.cu"
MAX_CHUNK = 256                    # rows of one chunk (Q)
TILE = 64                          # chunk rows a tile (the C Bᵀ tiles)
MAX_STATE = 128                    # state width (N)
P_SLICES = (64, 32, 16)            # P columns one thread block owns
_FN = {torch.float32: "ssd_scan_f32", torch.bfloat16: "ssd_scan_bf16"}
_BOUND: dict = {}     # dtype -> C function with its signature set


def _function(dtype: torch.dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[dtype])
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [
            ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def p_slice(P: int) -> int:
    """The P columns one thread block owns: the widest slice that divides
    P. Every block reads its chunk's scores, C and B tiles whatever its
    slice, so the widest slice moves the fewest bytes."""
    return next(s for s in P_SLICES if P % s == 0)


def _check(xt, da, Bm, Cm, chunk, h0) -> None:
    if xt.device.type != "cuda":
        raise ValueError(f"ssd_scan launches on CUDA tensors, got xt on "
                         f"{xt.device}")
    for name, t in (("da", da), ("Bm", Bm), ("Cm", Cm), ("h0", h0)):
        if t is not None and t.device != xt.device:
            raise ValueError(f"{name} is on {t.device}, xt on {xt.device}")
    if xt.dtype not in _FN or Bm.dtype != xt.dtype or Cm.dtype != xt.dtype:
        raise ValueError(f"xt, Bm and Cm must all be float32 or bfloat16, "
                         f"got {xt.dtype}, {Bm.dtype}, {Cm.dtype}")
    if da.dtype != torch.float32 or (h0 is not None
                                     and h0.dtype != torch.float32):
        raise ValueError("da and h0 must be float32")
    if xt.dim() != 4:
        raise ValueError(f"xt {tuple(xt.shape)} must be (B, L, H, P)")
    B, L, H, P = xt.shape
    if tuple(da.shape) != (B, L, H):
        raise ValueError(f"da {tuple(da.shape)} must be {(B, L, H)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (B, L) or Cm.shape != Bm.shape:
        raise ValueError(f"Bm {tuple(Bm.shape)} and Cm {tuple(Cm.shape)} "
                         f"must both be (B, L, N) with B, L = {B}, {L}")
    N = Bm.shape[2]
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"h0 {tuple(h0.shape)} must be {(B, H, P, N)}")
    if L < 1 or chunk < 1 or not 1 <= N <= MAX_STATE:
        raise ValueError(f"need L >= 1, chunk >= 1 and 1 <= N <= "
                         f"{MAX_STATE}; got L {L}, chunk {chunk}, N {N}")
    if min(chunk, L) > MAX_CHUNK:
        raise ValueError(f"chunk {min(chunk, L)} exceeds {MAX_CHUNK}")
    if P % 16:
        raise ValueError(f"head_dim {P} must be a multiple of 16")
    n_chunks = -(-L // min(chunk, L))
    if B > 65535 or n_chunks > 65535 or n_chunks * H >= 2 ** 31:
        raise ValueError(f"B {B} or L / chunk {n_chunks} exceeds the grid")
    for name, t in (("xt", xt), ("da", da), ("h0", h0)):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bm.stride() != Cm.stride() or Bm.stride(2) != 1:
        raise ValueError(f"Bm and Cm need one stride pair and unit stride "
                         f"over N, got {Bm.stride()} and {Cm.stride()}")


def ssd_scan(xt: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None) -> tuple:
    """Launch the kernel on the current stream. xt: (B, L, H, P); da:
    (B, L, H) f32; Bm, Cm: (B, L, N), read by stride; h0: None (zero) or
    (B, H, P, N) f32. Chunks of ``min(chunk, L)`` rows, any L (the tail
    reads as ``da = 0`` and zero rows). Returns (y (B, L, H, P) in xt's
    dtype, final state (B, H, P, N) f32). Raises on anything the kernel
    does not take."""
    _check(xt, da, Bm, Cm, chunk, h0)
    B, L, H, P = xt.shape
    N = Bm.shape[2]
    Q = min(chunk, L)
    nc = -(-L // Q)
    Qp = -(-Q // TILE) * TILE
    dev = xt.device
    y = torch.empty_like(xt)
    h_out = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    # scratch: each chunk's C Bᵀ (shared by the heads), each chunk's state
    # (then the state entering it), each chunk's decay exp(Lc_last)
    cb = torch.empty((B, nc, Qp, Qp), dtype=torch.float32, device=dev)
    hs = torch.empty((B, nc, H, P, N), dtype=torch.float32, device=dev)
    dec = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _function(xt.dtype)(
        xt.data_ptr(), da.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        cb.data_ptr(), hs.data_ptr(), dec.data_ptr(),
        0 if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        B, L, H, P, N, Q, p_slice(P), Bm.stride(0),
        Bm.stride(1), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error "
                           f"{err}")
    counters.record("ssd_scan")
    return y, h_out
