"""Launchers for the CUDA block-sparse matmuls (``csrc/block_sparse.cu``).

The GPU counterparts of the TPU kernels
``repro/kernels/block_sparse/kernel.py::block_sparse_matmul`` (kernel 1:
y = x @ w, visiting only the nonzero (K-block, N-block) tiles a plan
names) and ``::quant_block_sparse_matmul`` (kernel 5: the same walk over
the plan's kept tiles stored as int8 with one pow2 scale each). The
library is built with ``nvcc`` at first launch and bound with
``ctypes``; nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters

SOURCE = "block_sparse.cu"
BLOCKS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
_FN = {("dense", torch.float32): "block_sparse_matmul_f32",
       ("dense", torch.bfloat16): "block_sparse_matmul_bf16",
       ("int8", torch.float32): "quant_block_sparse_matmul_f32",
       ("int8", torch.bfloat16): "quant_block_sparse_matmul_bf16"}
_N_PTR = {"dense": 5, "int8": 7}
_BOUND: dict = {}     # (weight, dtype) -> C function with its signature


def _function(weight: str, dtype: torch.dtype):
    fn = _BOUND.get((weight, dtype))
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[(weight, dtype)])
        fn.argtypes = [ctypes.c_void_p] * _N_PTR[weight] + [
            ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[(weight, dtype)] = fn
    return fn


def _check(x, counts, indices, block: int, N: int) -> None:
    """x (M, K) and the plan of an (K, N) weight."""
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul launches on CUDA tensors, "
                         f"got x on {x.device}")
    for name, t in (("counts", counts), ("indices", indices)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in DTYPES:
        raise ValueError(f"x must be float32 or bfloat16, got {x.dtype}")
    if counts.dtype != torch.int32 or indices.dtype != torch.int32:
        raise ValueError("counts and indices must be int32")
    if block not in BLOCKS:
        raise ValueError(f"block {block} not in {BLOCKS}")
    if x.dim() != 2 or x.shape[1] % block or N % block:
        raise ValueError(f"x {tuple(x.shape)} and N = {N} do not tile by "
                         f"{block}")
    if counts.shape != (N // block,) or indices.dim() != 2 \
            or indices.shape[0] != N // block or indices.shape[1] < 1:
        raise ValueError(f"plan counts {tuple(counts.shape)} / indices "
                         f"{tuple(indices.shape)} do not match N/b = "
                         f"{N // block}")
    if x.shape[0] > 65535 * 16:
        raise ValueError(f"M = {x.shape[0]} exceeds the grid's row limit")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")


def _check_dense(x, w) -> None:
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    if w.dim() != 2 or x.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes x {tuple(x.shape)} w {tuple(w.shape)} "
                         f"do not multiply")
    if not w.is_contiguous():
        raise ValueError("w must be contiguous")


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        counts: torch.Tensor, indices: torch.Tensor,
                        block: int) -> torch.Tensor:
    """Launch the kernel on the current stream. x: (M, K); w: (K, N);
    counts: (N/b,) int32; indices: (N/b, max_nnz) int32. Returns y
    (M, N) in x's dtype. Raises on anything the kernel does not take."""
    _check_dense(x, w)
    _check(x, counts, indices, block, w.shape[1])
    M, K = x.shape
    N = w.shape[1]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function("dense", x.dtype)(
        x.data_ptr(), w.data_ptr(), counts.data_ptr(), indices.data_ptr(),
        y.data_ptr(), M, K, N, indices.shape[1], block, stream)
    if err != 0:
        raise RuntimeError(f"block_sparse kernel launch failed: CUDA "
                           f"error {err}")
    counters.record("block_sparse")
    return y


def check_int8_storage(tiles, slots, scales, indices, block: int) -> None:
    """The int8 operands against the plan: ``tiles`` (T, b, b) int8,
    ``slots`` int32 and ``scales`` f32 shaped like ``indices``, all
    contiguous on ``indices``' device. (That every slot lies below T is
    checked once, when the plan is packed or loaded.)"""
    for name, t in (("tiles", tiles), ("slots", slots), ("scales", scales)):
        if t.device != indices.device:
            raise ValueError(f"{name} is on {t.device}, the plan on "
                             f"{indices.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tiles.dtype != torch.int8 or tiles.dim() != 3 \
            or tiles.shape[1:] != (block, block) or tiles.shape[0] < 1:
        raise ValueError(f"tiles must be (T, {block}, {block}) int8, got "
                         f"{tuple(tiles.shape)} {tiles.dtype}")
    if slots.dtype != torch.int32 or scales.dtype != torch.float32:
        raise ValueError(f"slots must be int32 and scales float32, got "
                         f"{slots.dtype} and {scales.dtype}")
    if slots.shape != indices.shape or scales.shape != indices.shape:
        raise ValueError(f"slots {tuple(slots.shape)} / scales "
                         f"{tuple(scales.shape)} must match indices "
                         f"{tuple(indices.shape)}")


def quant_block_sparse_matmul(x: torch.Tensor, tiles: torch.Tensor,
                              counts: torch.Tensor, indices: torch.Tensor,
                              slots: torch.Tensor, scales: torch.Tensor,
                              block: int) -> torch.Tensor:
    """Launch kernel 5 on the current stream. x: (M, K) f32 or bf16;
    tiles: (T, b, b) int8 kept tiles; counts (N/b,), indices / slots
    (N/b, max_nnz) int32; scales (N/b, max_nnz) f32 pow2. Returns y
    (M, N) in x's dtype, bitwise equal to kernel 1 over the dequantised
    weight. Raises on anything the kernel does not take."""
    N = counts.shape[0] * block
    _check(x, counts, indices, block, N)
    check_int8_storage(tiles, slots, scales, indices, block)
    M, K = x.shape
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function("int8", x.dtype)(
        x.data_ptr(), tiles.data_ptr(), counts.data_ptr(),
        indices.data_ptr(), slots.data_ptr(), scales.data_ptr(),
        y.data_ptr(), M, K, N, indices.shape[1], block, stream)
    if err != 0:
        raise RuntimeError(f"quant block_sparse kernel launch failed: "
                           f"CUDA error {err}")
    counters.record("block_sparse_quant")
    return y
