"""Launchers for the CUDA grouped and ragged block-sparse matmuls
(``csrc/grouped_block_sparse.cu``).

The GPU counterparts of the TPU kernels
``repro/kernels/grouped_block_sparse/kernel.py::grouped_block_sparse_matmul``
(y[e] = x[e] @ w[e] for every MoE expert in one launch, dead (expert,
panel) pairs written as zeros) and ``::ragged_block_sparse_matmul``
(routed tokens packed in 16-row per-expert tiles, each tile times its
owning expert's weight, dead tiles written as zeros). Both visit only
the nonzero (K-block, N-block) tiles of each expert's plan. The library
is built with ``nvcc`` at first launch and bound with ``ctypes``;
nothing is built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters

SOURCE = "grouped_block_sparse.cu"
BLOCKS = (16, 32, 64, 128)
TILE_ROWS = 16                     # output rows per thread block
_FN = {("grouped", torch.float32): "grouped_block_sparse_matmul_f32",
       ("grouped", torch.bfloat16): "grouped_block_sparse_matmul_bf16",
       ("ragged", torch.float32): "ragged_block_sparse_matmul_f32",
       ("ragged", torch.bfloat16): "ragged_block_sparse_matmul_bf16"}
_BOUND: dict = {}     # (variant, dtype) -> C function with its signature


def _function(variant: str, dtype: torch.dtype):
    fn = _BOUND.get((variant, dtype))
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[(variant, dtype)])
        n_int = 7 if variant == "grouped" else 6
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * n_int + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[(variant, dtype)] = fn
    return fn


def _check_common(name: str, x, w, counts, indices, extra: dict,
                  block: int) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got x on "
                         f"{x.device}")
    tensors = {"w": w, "counts": counts, "indices": indices, **extra}
    for tname, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{tname} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or w.dtype != x.dtype:
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"{x.dtype} and {w.dtype}")
    for tname in ("counts", "indices", *extra):
        if tensors[tname].dtype != torch.int32:
            raise ValueError(f"{tname} must be int32")
    if block not in BLOCKS:
        raise ValueError(f"block {block} not in {BLOCKS}")
    if w.dim() != 3:
        raise ValueError(f"w must be an (E, K, N) stack, got "
                         f"{tuple(w.shape)}")
    E, K, N = w.shape
    if K % block or N % block:
        raise ValueError(f"w {tuple(w.shape)} does not tile by {block}")
    if counts.shape != (E, N // block) or indices.dim() != 3 \
            or indices.shape[:2] != (E, N // block) or indices.shape[2] < 1:
        raise ValueError(f"plan counts {tuple(counts.shape)} / indices "
                         f"{tuple(indices.shape)} do not match (E, N/b) = "
                         f"({E}, {N // block})")
    for tname, t in (("x", x), *tensors.items()):
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def grouped_block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                                counts: torch.Tensor, indices: torch.Tensor,
                                work: torch.Tensor, block: int,
                                block_m: int) -> torch.Tensor:
    """Launch the grouped kernel on the current stream. x: (E, M, K);
    w: (E, K, N); counts: (E, N/b) int32; indices: (E, N/b, max_nnz)
    int32; work: (E, M/block_m) int32 occupancy (0 = the panel's rows are
    written as zeros). Returns y (E, M, N) in x's dtype."""
    _check_common("grouped_block_sparse_matmul", x, w, counts, indices,
                  {"work": work}, block)
    E, K, N = w.shape
    if x.dim() != 3 or x.shape[0] != E or x.shape[2] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    M = x.shape[1]
    if block_m < 1 or block_m % TILE_ROWS or M % block_m:
        raise ValueError(f"block_m {block_m} must be a multiple of "
                         f"{TILE_ROWS} that divides M = {M}")
    if work.shape != (E, M // block_m):
        raise ValueError(f"work {tuple(work.shape)} is not (E, M/block_m) "
                         f"= ({E}, {M // block_m})")
    if M // TILE_ROWS > 65535 or E > 65535:
        raise ValueError(f"(M, E) = ({M}, {E}) exceeds the grid's limits")
    y = torch.empty((E, M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function("grouped", x.dtype)(
        x.data_ptr(), w.data_ptr(), counts.data_ptr(), indices.data_ptr(),
        work.data_ptr(), y.data_ptr(), E, M, K, N, indices.shape[2], block,
        block_m, stream)
    if err != 0:
        raise RuntimeError(f"grouped_block_sparse kernel launch failed: "
                           f"CUDA error {err}")
    counters.record("grouped_block_sparse")
    return y


def ragged_block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                               counts: torch.Tensor, indices: torch.Tensor,
                               tile_expert: torch.Tensor,
                               block: int) -> torch.Tensor:
    """Launch the ragged kernel on the current stream. x: (M, K) with M a
    multiple of 16; w: (E, K, N); counts / indices: the stacked plan;
    tile_expert: (M/16,) int32, each tile's expert (< 0: zeros). Returns
    y (M, N) in x's dtype."""
    _check_common("ragged_block_sparse_matmul", x, w, counts, indices,
                  {"tile_expert": tile_expert}, block)
    E, K, N = w.shape
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{tuple(w.shape)}")
    M = x.shape[0]
    if M % TILE_ROWS or tile_expert.shape != (M // TILE_ROWS,):
        raise ValueError(f"M = {M} must be a multiple of {TILE_ROWS} and "
                         f"tile_expert {tuple(tile_expert.shape)} must be "
                         f"(M/{TILE_ROWS},)")
    if M // TILE_ROWS > 65535:
        raise ValueError(f"M = {M} exceeds the grid's row limit")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _function("ragged", x.dtype)(
        x.data_ptr(), w.data_ptr(), counts.data_ptr(), indices.data_ptr(),
        tile_expert.data_ptr(), y.data_ptr(), M, K, N, E, indices.shape[2],
        block, stream)
    if err != 0:
        raise RuntimeError(f"ragged_block_sparse kernel launch failed: "
                           f"CUDA error {err}")
    counters.record("grouped_block_sparse_ragged")
    return y
