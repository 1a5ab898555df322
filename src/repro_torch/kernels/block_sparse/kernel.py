"""Launcher for the CUDA block-sparse matmul (``csrc/block_sparse.cu``).

The GPU counterpart of the TPU kernel
``repro/kernels/block_sparse/kernel.py::block_sparse_matmul``: y = x @ w,
visiting only the nonzero (K-block, N-block) tiles a plan names. The
library is built with ``nvcc`` at first launch and bound with
``ctypes``; nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters

SOURCE = "block_sparse.cu"
BLOCKS = (16, 32, 64, 128)
_FN = {torch.float32: "block_sparse_matmul_f32",
       torch.bfloat16: "block_sparse_matmul_bf16"}
_BOUND: dict = {}     # dtype -> C function with its signature set


def _function(dtype: torch.dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[dtype])
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def _check(x, w, counts, indices, block: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul launches on CUDA tensors, "
                         f"got x on {x.device}")
    for name, t in (("w", w), ("counts", counts), ("indices", indices)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in _FN or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    if counts.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError("counts and indices must be int32")
    if block not in BLOCKS:
        raise ValueError(f"block {block} not in {BLOCKS}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"do not multiply")
    K, N = w.shape
    if K % block or N % block:
        raise ValueError(f"w {tuple(w.shape)} does not tile by {block}")
    if counts.shape != (N // block,) or indices.dim() != 2 \
            or indices.shape[0] != N // block or indices.shape[1] < 1:
        raise ValueError(f"plan counts {tuple(counts.shape)} / indices "
                         f"{tuple(indices.shape)} do not match N/b = "
                         f"{N // block}")
    if x.shape[0] > 65535 * 16:
        raise ValueError(f"M = {x.shape[0]} exceeds the grid's row limit")
    for name, t in (("x", x), ("w", w), ("counts", counts),
                    ("indices", indices)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor, indices: torch.Tensor,
                        block: int) -> torch.Tensor:
    """Launch the kernel on the current stream. x: (M, K); w: (K, N);
    counts: (N/b,) int32; indices: (N/b, max_nnz) int32. Returns y
    (M, N) in x's dtype. Raises on anything the kernel does not take."""
    _check(x, w, counts, indices, block)
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function(x.dtype)(
        x.data_ptr(), w.data_ptr(), counts.data_ptr(), indices.data_ptr(),
        y.data_ptr(), M, K, N, indices.shape[1], block, stream)
    if err != 0:
        raise RuntimeError(f"block_sparse kernel launch failed: CUDA "
                           f"error {err}")
    counters.record("block_sparse")
    return y
