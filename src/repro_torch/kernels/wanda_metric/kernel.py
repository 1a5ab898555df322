"""Launcher for the CUDA Wanda-metric partial reduction
(``csrc/wanda_metric.cu``; POD, Eqs. 5-6).

The GPU counterpart of the TPU kernel ``repro/kernels/wanda_metric/
kernel.py::wanda_partials``. One thread block per (BLOCK_K, BLOCK_N)
tile of ``w`` reads the tile once, forms ω = |W|·‖A‖₂ in registers and
writes one f32 partial: the tile's sum of ω, or its count of ω above a
threshold read from a one-element device tensor (so the mean never
travels to the host). The metric tensor is never written to device
memory; edges are masked, so any (K, N) is taken. The library is built
with ``nvcc`` at first launch and bound with ``ctypes``; nothing is
built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, counters

SOURCE = "wanda_metric.cu"
BLOCK_K = 64
BLOCK_N = 256
_FN = {torch.float32: "wanda_partials_f32",
       torch.bfloat16: "wanda_partials_bf16"}
_BOUND: dict = {}     # dtype -> C function with its signature set


def _function(dtype: torch.dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def wanda_partials(w: torch.Tensor, anorm: torch.Tensor,
                   threshold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch on the current stream. w: (K, N) f32/bf16 with unit stride
    over N; anorm: (K,) f32; threshold: None (per-tile sums) or a
    one-element f32 tensor on w's device (per-tile counts of ω >
    threshold). Returns the (ceil(K/BLOCK_K), ceil(N/BLOCK_N)) f32
    partials. Raises on CPU tensors and on anything else the kernel does
    not take."""
    if w.device.type != "cuda":
        raise ValueError(f"wanda_partials launches on CUDA tensors, got w "
                         f"on {w.device}")
    if w.dim() != 2 or anorm.shape != (w.shape[0],):
        raise ValueError(f"w {tuple(w.shape)} / anorm {tuple(anorm.shape)}"
                         f": expected (K, N) and (K,)")
    if w.dtype not in _FN or anorm.dtype != torch.float32:
        raise ValueError(f"w must be f32/bf16 and anorm f32, got {w.dtype}"
                         f", {anorm.dtype}")
    if anorm.device != w.device or (threshold is not None and (
            threshold.device != w.device or threshold.numel() != 1
            or threshold.dtype != torch.float32)):
        raise ValueError("anorm and threshold must be f32 on w's device "
                         "(threshold: one element)")
    if w.stride(1) != 1 or not anorm.is_contiguous():
        raise ValueError("w must be row-major, anorm contiguous")
    K, N = w.shape
    grid = (-(-K // BLOCK_K), -(-N // BLOCK_N))
    if K < 1 or N < 1 or grid[0] > 65535:
        raise ValueError(f"w {tuple(w.shape)}: need 1 <= K <= "
                         f"{65535 * BLOCK_K} and N >= 1")
    out = torch.empty(grid, dtype=torch.float32, device=w.device)
    err = _function(w.dtype)(
        w.data_ptr(), anorm.data_ptr(),
        None if threshold is None else threshold.data_ptr(),
        out.data_ptr(), K, N, w.stride(0),
        torch.cuda.current_stream(w.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wanda_partials kernel launch failed: CUDA "
                           f"error {err}")
    counters.record("wanda_partials")
    return out
