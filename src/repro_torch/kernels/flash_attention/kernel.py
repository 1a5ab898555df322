"""Launcher for the CUDA causal flash attention
(``csrc/flash_attention.cu``).

The GPU counterpart of the TPU kernel
``repro/kernels/flash_attention/kernel.py::flash_attention``: causal GQA
self-attention with an online softmax over KV tiles, strictly future
tiles skipped and only the diagonal tile masked. The kernel reads and
writes the model's (B, S, H, D) layout directly, so the wrapper makes no
layout copies. The library is built with ``nvcc`` at first launch and
bound with ``ctypes``; nothing is built or loaded when this module is
imported.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, counters

SOURCE = "flash_attention.cu"
TILE = 64                          # query and kv rows per tile
HEAD_DIMS = (16, 32, 64, 128)
_FN = {torch.float32: "flash_attention_f32",
       torch.bfloat16: "flash_attention_bf16"}
_BOUND: dict = {}     # dtype -> C function with its signature set


def _function(dtype: torch.dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[dtype])
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def _check(q, k, v) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches on CUDA tensors, got q "
                         f"on {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in _FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k and v must all be float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)} must be (B, S, n_q, D) and "
                         f"k {tuple(k.shape)} / v {tuple(v.shape)} one "
                         f"(B, S, n_kv, D) shape")
    B, S, n_q, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D \
            or n_q % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} does not group over k "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if S < TILE or S % TILE:
        raise ValueError(f"seq {S} must be a positive multiple of {TILE}")
    if B * n_q > 65535:
        raise ValueError(f"B * n_q = {B * n_q} exceeds the grid")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. q: (B, S, n_q, D); k, v:
    (B, S, n_kv, D). Returns causal attention (B, S, n_q, D) in q's
    dtype. Raises on anything the kernel does not take."""
    _check(q, k, v)
    B, S, n_q, D = q.shape
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _function(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, n_q, k.shape[2], D, 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    counters.record("flash_attention")
    return out
