"""Launchers for the CUDA block-sparse matmuls (``csrc/block_sparse.cu``).

The GPU counterparts of the TPU kernels
``repro/kernels/block_sparse/kernel.py::block_sparse_matmul`` (kernel 1:
y = x @ w, visiting only the nonzero (K-block, N-block) tiles a plan
names) and ``::quant_block_sparse_matmul`` (kernel 5: the same walk over
the plan's kept tiles stored as int8 with one pow2 scale each). The
library is built with ``nvcc`` at first launch and bound with
``ctypes``; nothing is built or loaded when this module is imported.
``tile_config`` states, without a card, the tile each launch takes.
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

# The tile rule of csrc/block_sparse.cu (``choose`` and
# block_sparse_pipe.cuh), mirrored: each warp owns one (M-tile x
# col_width) output slice of one plan column and streams it through a
# ring of ``stages`` 16-row K items. ``library_tile_config`` returns the
# C side's choice; chip_smoke.py and the card's tests hold the two equal.
K_ROWS = 16                    # K rows per ring item


def tile_config(M: int, block: int, dtype: torch.dtype,
                weight: str = "dense") -> dict:
    """The tile kernel 1 (``weight="dense"``) or kernel 5 (``"int8"``)
    launches for x (M, K) and a weight planned in ``block`` tiles:
    16-row M-tiles at decode, 64-row ones from M = 64 (a column's weight
    tiles are then read once per 64 rows, not per 16); 8-column warp
    slices for f32 at 16 rows (twice the warps to share the FFMA issue
    of a decode launch), 16-column ones otherwise; a deeper ring for
    16-row tiles, whose items are small; 2 warps per thread block (4 for
    bf16 at 16 rows); FFMA in f32, ``mma.sync`` in bf16. The block size
    only sets how many slices a plan column has."""
    if block not in BLOCKS or dtype not in DTYPES \
            or weight not in _N_PTR:
        raise ValueError(f"no tile for block {block}, {dtype}, {weight}")
    int8 = weight == "int8"
    bf16 = dtype == torch.bfloat16
    m_tile = 64 if M >= 64 else 16
    col_width = 8 if m_tile == 16 and not bf16 else 16
    if m_tile == 16:
        stages = 12 if int8 else 8
    else:
        stages = 6 if bf16 else 4
    warps = 4 if bf16 and m_tile == 16 else 2
    # shared-memory rows in elements: x row, weight row (padded)
    size = 2 if bf16 else 4
    x_row = K_ROWS + (8 if bf16 else 4)
    w_row = 24 if bf16 else col_width
    stage = m_tile * x_row * size + (
        K_ROWS * 16 if int8 else K_ROWS * w_row * size)
    warp_bytes = stages * stage
    if int8:     # the dequantised tile and one scale per stage
        warp_bytes += K_ROWS * w_row * size + -(-stages * 4 // 16) * 16
    return {"m_tile": m_tile, "stages": stages, "warps": warps,
            "mma": "mma.sync" if bf16 else "ffma",
            "col_width": col_width, "slices": block // col_width,
            "smem_bytes": warps * warp_bytes}


def library_tile_config(M: int, block: int, dtype: torch.dtype,
                        weight: str = "dense") -> dict:
    """The C side's choice (builds the library): the keys of
    ``tile_config`` that the launch decides."""
    fn = _BOUND.get("config")
    if fn is None:
        fn = build.load(SOURCE).block_sparse_tile_config
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND["config"] = fn
    out = (ctypes.c_int * 5)()
    fn(M, int(dtype == torch.bfloat16), int(weight == "int8"),
       ctypes.addressof(out))
    return {"m_tile": out[0], "stages": out[1], "warps": out[2],
            "mma": ("ffma", "mma.sync")[out[3]], "smem_bytes": out[4]}


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


def _check_aligned(**tensors) -> None:
    """The kernels copy 16-byte chunks: every operand starts on 16."""
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on 16 bytes (a view at "
                             f"an offset of {t.storage_offset()} elements "
                             f"does not)")


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
    _check_aligned(x=x, w=w)
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
    _check_aligned(x=x, tiles=tiles)
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
