"""Launchers for the CUDA grouped and ragged block-sparse matmuls
(``csrc/grouped_block_sparse.cu``).

The GPU counterparts of the TPU kernels
``repro/kernels/grouped_block_sparse/kernel.py::grouped_block_sparse_matmul``
(kernel 6: y[e] = x[e] @ w[e] for every MoE expert in one launch, dead
(expert, panel) pairs written as zeros), ``::ragged_block_sparse_matmul``
(kernel 7: routed tokens packed in 16-row per-expert tiles, each tile
times its owning expert's weight, dead tiles written as zeros), and
their int8 kept-tile variants ``::quant_grouped_block_sparse_matmul``
(kernel 8) and ``::quant_ragged_block_sparse_matmul`` (kernel 9), which
read every expert's kept tiles from one int8 array through absolute
slots. All visit only the nonzero (K-block, N-block) tiles of each
expert's plan. The library is built with ``nvcc`` at first launch and
bound with ``ctypes``; nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, counters
from repro_torch.kernels.block_sparse.kernel import check_int8_storage

SOURCE = "grouped_block_sparse.cu"
BLOCKS = (16, 32, 64, 128)
TILE_ROWS = 16                     # output rows per thread block
_FN = {("grouped", torch.float32): "grouped_block_sparse_matmul_f32",
       ("grouped", torch.bfloat16): "grouped_block_sparse_matmul_bf16",
       ("ragged", torch.float32): "ragged_block_sparse_matmul_f32",
       ("ragged", torch.bfloat16): "ragged_block_sparse_matmul_bf16",
       ("quant_grouped", torch.float32):
           "quant_grouped_block_sparse_matmul_f32",
       ("quant_grouped", torch.bfloat16):
           "quant_grouped_block_sparse_matmul_bf16",
       ("quant_ragged", torch.float32):
           "quant_ragged_block_sparse_matmul_f32",
       ("quant_ragged", torch.bfloat16):
           "quant_ragged_block_sparse_matmul_bf16"}
_BOUND: dict = {}     # (variant, dtype) -> C function with its signature


def _function(variant: str, dtype: torch.dtype):
    fn = _BOUND.get((variant, dtype))
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[(variant, dtype)])
        n_ptr = 8 if variant.startswith("quant") else 6
        n_int = 7 if variant.endswith("grouped") else 6
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[(variant, dtype)] = fn
    return fn


def _check_common(name: str, x, w, counts, indices, extra: dict,
                  block: int) -> None:
    """x, the stacked plan, the map in ``extra`` and the weight: a dense
    (E, K, N) stack ``w``, or for the int8 kernels a tuple ``(tiles,
    slots, scales, (E, K, N))`` of the storage and the stack's shape."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} launches on CUDA tensors, got x on "
                         f"{x.device}")
    quant = isinstance(w, tuple)
    tensors = {"counts": counts, "indices": indices, **extra}
    if not quant:
        tensors["w"] = w
    for tname, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"{tname} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16) or (
            not quant and w.dtype != x.dtype):
        raise ValueError(f"x and w must both be float32 or bfloat16, got "
                         f"{x.dtype} and {'int8 tiles' if quant else w.dtype}")
    for tname in ("counts", "indices", *extra):
        if tensors[tname].dtype != torch.int32:
            raise ValueError(f"{tname} must be int32")
    if block not in BLOCKS:
        raise ValueError(f"block {block} not in {BLOCKS}")
    shape = w[3] if quant else tuple(w.shape)
    if len(shape) != 3:
        raise ValueError(f"w must be an (E, K, N) stack, got {shape}")
    if quant:
        check_int8_storage(*w[:3], indices, block)
    E, K, N = shape
    if K % block or N % block:
        raise ValueError(f"w {shape} does not tile by {block}")
    if counts.shape != (E, N // block) or indices.dim() != 3 \
            or indices.shape[:2] != (E, N // block) or indices.shape[2] < 1:
        raise ValueError(f"plan counts {tuple(counts.shape)} / indices "
                         f"{tuple(indices.shape)} do not match (E, N/b) = "
                         f"({E}, {N // block})")
    for tname, t in (("x", x), *tensors.items()):
        if not t.is_contiguous():
            raise ValueError(f"{tname} must be contiguous")


def _weight(w) -> tuple:
    """``((E, K, N), data pointers)`` of a dense stack ``w`` or of an
    int8 ``(tiles, slots, scales, shape)`` tuple, the pointers in the C
    entry points' order (the first one before the plan, the rest after
    it)."""
    if isinstance(w, tuple):
        return w[3], [t.data_ptr() for t in w[:3]]
    return tuple(w.shape), [w.data_ptr()]


def _grouped(variant: str, x, w, counts, indices, work, block: int,
             block_m: int) -> torch.Tensor:
    _check_common(f"{variant}_block_sparse_matmul", x, w, counts, indices,
                  {"work": work}, block)
    (E, K, N), weight = _weight(w)
    if x.dim() != 3 or x.shape[0] != E or x.shape[2] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{(E, K, N)}")
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
    err = _function(variant, x.dtype)(
        x.data_ptr(), weight[0], counts.data_ptr(), indices.data_ptr(),
        *weight[1:], work.data_ptr(), y.data_ptr(), E, M, K, N,
        indices.shape[2], block, block_m, stream)
    if err != 0:
        raise RuntimeError(f"{variant}_block_sparse kernel launch failed: "
                           f"CUDA error {err}")
    return y


def _ragged(variant: str, x, w, counts, indices, tile_expert,
            block: int) -> torch.Tensor:
    _check_common(f"{variant}_block_sparse_matmul", x, w, counts, indices,
                  {"tile_expert": tile_expert}, block)
    (E, K, N), weight = _weight(w)
    if x.dim() != 2 or x.shape[1] != K:
        raise ValueError(f"x {tuple(x.shape)} does not match w "
                         f"{(E, K, N)}")
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
    err = _function(variant, x.dtype)(
        x.data_ptr(), weight[0], counts.data_ptr(), indices.data_ptr(),
        *weight[1:], tile_expert.data_ptr(), y.data_ptr(), M, K, N, E,
        indices.shape[2], block, stream)
    if err != 0:
        raise RuntimeError(f"{variant}_block_sparse kernel launch failed: "
                           f"CUDA error {err}")
    return y


def _storage(x, tiles, counts, slots, scales, block: int) -> tuple:
    """The int8 operands with the (E, K, N) shape of the stack they
    encode (a plan of the wrong rank fails the plan-shape check)."""
    return tiles, slots, scales, (counts.shape[0], x.shape[-1],
                                  counts.shape[-1] * block)


def grouped_block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                                counts: torch.Tensor, indices: torch.Tensor,
                                work: torch.Tensor, block: int,
                                block_m: int) -> torch.Tensor:
    """Launch kernel 6 on the current stream. x: (E, M, K); w: (E, K, N);
    counts: (E, N/b) int32; indices: (E, N/b, max_nnz) int32; work:
    (E, M/block_m) int32 occupancy (0 = the panel's rows are written as
    zeros). Returns y (E, M, N) in x's dtype."""
    y = _grouped("grouped", x, w, counts, indices, work, block, block_m)
    counters.record("grouped_block_sparse")
    return y


def ragged_block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                               counts: torch.Tensor, indices: torch.Tensor,
                               tile_expert: torch.Tensor,
                               block: int) -> torch.Tensor:
    """Launch kernel 7 on the current stream. x: (M, K) with M a multiple
    of 16; w: (E, K, N); counts / indices: the stacked plan; tile_expert:
    (M/16,) int32, each tile's expert (< 0: zeros). Returns y (M, N) in
    x's dtype."""
    y = _ragged("ragged", x, w, counts, indices, tile_expert, block)
    counters.record("grouped_block_sparse_ragged")
    return y


def quant_grouped_block_sparse_matmul(x: torch.Tensor, tiles: torch.Tensor,
                                      counts: torch.Tensor,
                                      indices: torch.Tensor,
                                      slots: torch.Tensor,
                                      scales: torch.Tensor,
                                      work: torch.Tensor, block: int,
                                      block_m: int) -> torch.Tensor:
    """Launch kernel 8: kernel 6 over int8 storage. tiles: (T, b, b) int8,
    every expert's kept tiles; slots (E, N/b, max_nnz) int32 absolute
    storage rows; scales (E, N/b, max_nnz) f32 pow2. Bitwise equal to
    kernel 6 over the dequantised stack."""
    y = _grouped("quant_grouped", x,
                 _storage(x, tiles, counts, slots, scales, block), counts,
                 indices, work, block, block_m)
    counters.record("grouped_block_sparse_quant")
    return y


def quant_ragged_block_sparse_matmul(x: torch.Tensor, tiles: torch.Tensor,
                                     counts: torch.Tensor,
                                     indices: torch.Tensor,
                                     slots: torch.Tensor,
                                     scales: torch.Tensor,
                                     tile_expert: torch.Tensor,
                                     block: int) -> torch.Tensor:
    """Launch kernel 9: kernel 7 over int8 storage (operands as in
    :func:`quant_grouped_block_sparse_matmul`). Bitwise equal to kernel 7
    over the dequantised stack."""
    y = _ragged("quant_ragged", x,
                _storage(x, tiles, counts, slots, scales, block), counts,
                indices, tile_expert, block)
    counters.record("grouped_block_sparse_ragged_quant")
    return y
