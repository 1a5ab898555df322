"""Launcher for the CUDA paged decode attention
(``csrc/paged_attention.cu``).

The GPU counterpart of the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_attention``: one query
token per sequence attends over its paged KV cache, read in place
through its block table, with an online softmax. The library is built
with ``nvcc`` at first launch and bound with ``ctypes``; nothing is
built or loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, counters

SOURCE = "paged_attention.cu"
SMEM_LIMIT = 227 * 1024           # bytes of shared memory a block may use
_FN = {torch.float32: "paged_attention_f32",
       torch.bfloat16: "paged_attention_bf16"}
_BOUND: dict = {}     # dtype -> C function with its signature set


def _function(dtype: torch.dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[dtype])
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def smem_bytes(group: int, D: int, block_size: int) -> int:
    """Dynamic shared memory one thread block asks for."""
    return 4 * (2 * group * D + 2 * block_size * D + group * block_size
                + 3 * group)


def _check(q, k_arena, v_arena, block_tables, lengths) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention launches on CUDA tensors, got q "
                         f"on {q.device}")
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _FN or k_arena.dtype != q.dtype \
            or v_arena.dtype != q.dtype:
        raise ValueError(f"q and the arenas must all be float32 or "
                         f"bfloat16, got {q.dtype}, {k_arena.dtype}, "
                         f"{v_arena.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    if q.dim() != 3 or k_arena.dim() != 4 or k_arena.shape != v_arena.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, n_q, D) and the "
                         f"arenas {tuple(k_arena.shape)} / "
                         f"{tuple(v_arena.shape)} one (n_blocks + 1, bs, "
                         f"n_kv, D) shape")
    B, n_q, D = q.shape
    _, bs, n_kv, Dk = k_arena.shape
    if Dk != D or n_kv < 1 or n_q % n_kv:
        raise ValueError(f"q {tuple(q.shape)} does not group over the "
                         f"arena's {n_kv} kv heads of width {Dk}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B \
            or block_tables.shape[1] < 1 or lengths.shape != (B,):
        raise ValueError(f"block_tables {tuple(block_tables.shape)} / "
                         f"lengths {tuple(lengths.shape)} do not match "
                         f"B = {B}")
    if B > 65535 or n_kv > 65535:
        raise ValueError(f"B = {B} or n_kv = {n_kv} exceeds the grid")
    if smem_bytes(n_q // n_kv, D, bs) > SMEM_LIMIT:
        raise ValueError(f"group {n_q // n_kv}, D {D}, block {bs} need more "
                         f"shared memory than a block has")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. q: (B, n_q, D); arenas:
    (n_blocks + 1, bs, n_kv, D); block_tables: (B, max_blocks) int32
    arena block ids; lengths: (B,) int32 valid KV positions per row.
    Returns (B, n_q, D) in q's dtype. Raises on anything the kernel does
    not take."""
    _check(q, k_arena, v_arena, block_tables, lengths)
    B, n_q, D = q.shape
    _, bs, n_kv, _ = k_arena.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _function(q.dtype)(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, n_q, n_kv, D, bs, block_tables.shape[1], 1.0 / math.sqrt(D),
        stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    counters.record("paged_attention")
    return out
