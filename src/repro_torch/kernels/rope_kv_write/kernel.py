"""Launcher for the paged step's prologue (``csrc/rope_kv_write.cu``):
RoPE of q and k from the step's cos/sin tables, q rotated in place, and
k and v written into the paged arenas at the step's arena rows, in one
launch on the current stream.

It replaces no TPU kernel: it is the one launch an attention layer keeps
of the eager RoPE and ``paged_write`` ops, whose host dispatch bound the
paged decode tick (the source's note). The library is built with
``nvcc`` at first launch and bound with ``ctypes``; nothing is built or
loaded when this module is imported.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, counters

SOURCE = "rope_kv_write.cu"
MAX_HEAD_DIM = 2048               # D / 2 threads a block
MAX_HEADS = 65535                 # the grid's second axis: n_q + n_kv
_TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BOUND: dict = {}     # (dtype, arena dtype) -> C function, signature set


def _function(dtype: torch.dtype, arena_dtype: torch.dtype):
    key = (dtype, arena_dtype)
    fn = _BOUND.get(key)
    if fn is None:
        fn = getattr(build.load(SOURCE), f"rope_kv_write_{_TYPES[dtype]}_"
                                         f"{_TYPES[arena_dtype]}")
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[key] = fn
    return fn


def _check(q, k, v, k_arena, v_arena, rows, cos, sin) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"rope_kv_write launches on CUDA tensors, got q on "
                         f"{dev}")
    named = (("k", k), ("v", v), ("k_arena", k_arena),
             ("v_arena", v_arena), ("rows", rows), ("cos", cos),
             ("sin", sin))
    for name, t in named:
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if (cos is None) != (sin is None):
        raise ValueError("cos and sin are both given (RoPE) or both None")
    if q.dtype not in _TYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must be one of float32 and bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if k_arena.dtype not in _TYPES or v_arena.dtype != k_arena.dtype:
        raise ValueError(f"the arenas must be one of float32 and bfloat16, "
                         f"got {k_arena.dtype}, {v_arena.dtype}")
    if rows.dtype != torch.int64:
        raise ValueError(f"rows must be int64, got {rows.dtype}")
    if cos is not None and (cos.dtype != torch.float32
                            or sin.dtype != torch.float32):
        raise ValueError(f"cos and sin must be float32, got {cos.dtype}, "
                         f"{sin.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k_arena.dim() != 4:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} must be "
                         f"(B, S, heads, D) and the arenas "
                         f"{tuple(k_arena.shape)} (n_blocks + 1, bs, n_kv, "
                         f"D)")
    B, S, n_q, D = q.shape
    n_kv = k.shape[2]
    if (k.shape != (B, S, n_kv, D) or v.shape != k.shape
            or k_arena.shape[2:] != (n_kv, D)
            or v_arena.shape != k_arena.shape or rows.shape != (B, S)):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, arenas {tuple(k_arena.shape)} / "
                         f"{tuple(v_arena.shape)} and rows "
                         f"{tuple(rows.shape)} do not agree")
    if cos is not None and (cos.shape != (B, S, D // 2)
                            or sin.shape != cos.shape):
        raise ValueError(f"cos {tuple(cos.shape)} / sin {tuple(sin.shape)} "
                         f"must be (B, S, D / 2) = {(B, S, D // 2)}")
    if D % 2 or not 0 < D <= MAX_HEAD_DIM or n_kv < 1 \
            or n_q + n_kv > MAX_HEADS or B * S >= 2 ** 31:
        raise ValueError(f"D {D}, {n_q} + {n_kv} heads, {B * S} tokens: the "
                         f"kernel takes even widths up to {MAX_HEAD_DIM}, up "
                         f"to {MAX_HEADS} heads and fewer than 2^31 tokens")
    for name, t in (("q", q),) + named:
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def rope_kv_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_arena: torch.Tensor, v_arena: torch.Tensor,
                  rows: torch.Tensor, cos: Optional[torch.Tensor] = None,
                  sin: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on the current stream. q (B, S, n_q, D), k, v
    (B, S, n_kv, D), all float32 or all bfloat16; arenas (n_blocks + 1,
    bs, n_kv, D), both float32 or both bfloat16; rows (B, S) int64 arena
    rows; cos, sin (B, S, D / 2) float32, or both None for the write
    alone. Rotates q in place and writes rotated k and v into the arenas.
    Raises on anything the kernel does not take; never synchronises or
    allocates. A row outside the arena traps the kernel (a CUDA error at
    the next sync), as the eager scatter's bounds assert does."""
    _check(q, k, v, k_arena, v_arena, rows, cos, sin)
    B, S, n_q, D = q.shape
    n_rows = k_arena.shape[0] * k_arena.shape[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _function(q.dtype, k_arena.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), k_arena.data_ptr(),
        v_arena.data_ptr(), None if cos is None else cos.data_ptr(),
        None if sin is None else sin.data_ptr(), rows.data_ptr(), B * S,
        n_q, k.shape[2], D, n_rows, stream)
    if err != 0:
        raise RuntimeError(f"rope_kv_write kernel launch failed: CUDA error "
                           f"{err}")
    counters.record("rope_kv_write")
