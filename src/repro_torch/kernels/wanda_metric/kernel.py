"""Triton kernel for the Wanda-metric partial reduction (POD, Eqs. 5-6).

Replaces the TPU kernel ``repro/kernels/wanda_metric/kernel.py::
wanda_partials``. One program per (K-block, N-block) tile of ``w`` reads
the tile once with masked loads, forms ω = |W|·‖A‖₂ in registers and
writes one f32 partial: the tile's sum of ω, or its count of ω above a
threshold. The metric tensor is never written to device memory.

Bound on the H100: a pure stream, one read of ``w`` (K·N·4 bytes in f32)
at 3.35 TB/s; three operations per element are far below the f32 peak.
Triton's block loads and ``tl.sum`` serve a reduction with no matrix
product as well as hand-written CUDA would. The threshold is read from a
one-element device tensor, so the mean never travels to the host between
the two passes (the TPU kernel had to fold it into ``anorm`` because its
threshold was static). Edges are masked, so any (K, N) is taken.

``triton`` is imported, and the kernel defined, at the first launch.
"""
from typing import Optional

import torch

from repro_torch.kernels import build, counters

BLOCK_K = 64
BLOCK_N = 256
_KERNEL = None
tl = None          # triton.language, bound at the first launch


def _build():
    global _KERNEL, tl
    if _KERNEL is not None:
        return _KERNEL
    build.triton_cache_dir()
    import triton
    import triton.language as tl

    @triton.jit
    def wanda_partials_kernel(w_ptr, a_ptr, t_ptr, out_ptr, K, N,
                              stride_k, grid_n,
                              COUNT: tl.constexpr, BK: tl.constexpr,
                              BN: tl.constexpr):
        pk = tl.program_id(0)
        pn = tl.program_id(1)
        rk = pk * BK + tl.arange(0, BK)
        rn = pn * BN + tl.arange(0, BN)
        mk = rk < K
        mn = rn < N
        w = tl.load(w_ptr + rk[:, None] * stride_k + rn[None, :],
                    mask=mk[:, None] & mn[None, :], other=0.0)
        a = tl.load(a_ptr + rk, mask=mk, other=0.0)
        metric = tl.abs(w.to(tl.float32)) * a.to(tl.float32)[:, None]
        if COUNT:
            t = tl.load(t_ptr)
            v = tl.sum(tl.sum((metric > t).to(tl.float32), axis=1), axis=0)
        else:
            v = tl.sum(tl.sum(metric, axis=1), axis=0)
        tl.store(out_ptr + pk * grid_n + pn, v)

    _KERNEL = wanda_partials_kernel
    return _KERNEL


def wanda_partials(w: torch.Tensor, anorm: torch.Tensor,
                   threshold: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch on the current stream. w: (K, N) f32/bf16, row-major;
    anorm: (K,); threshold: None (per-tile sums) or a one-element f32
    tensor on w's device (per-tile counts of ω > threshold). Returns the
    (ceil(K/BLOCK_K), ceil(N/BLOCK_N)) f32 partials. Raises on CPU
    tensors."""
    if w.device.type != "cuda":
        raise ValueError(f"wanda_partials launches on CUDA tensors, got w "
                         f"on {w.device}")
    if w.dim() != 2 or anorm.shape != (w.shape[0],):
        raise ValueError(f"w {tuple(w.shape)} / anorm {tuple(anorm.shape)}"
                         f": expected (K, N) and (K,)")
    if w.dtype not in (torch.float32, torch.bfloat16) \
            or anorm.dtype != torch.float32:
        raise ValueError(f"w must be f32/bf16 and anorm f32, got {w.dtype}"
                         f", {anorm.dtype}")
    if anorm.device != w.device or (threshold is not None and (
            threshold.device != w.device or threshold.numel() != 1
            or threshold.dtype != torch.float32)):
        raise ValueError("anorm and threshold must be f32 on w's device "
                         "(threshold: one element)")
    if w.stride(1) != 1 or not anorm.is_contiguous():
        raise ValueError("w must be row-major, anorm contiguous")
    kernel = _build()
    K, N = w.shape
    grid = (-(-K // BLOCK_K), -(-N // BLOCK_N))
    out = torch.empty(grid, dtype=torch.float32, device=w.device)
    t = threshold if threshold is not None else out   # unread when summing
    with torch.cuda.device(w.device):
        kernel[grid](w, anorm, t, out, K, N, w.stride(0), grid[1],
                     COUNT=threshold is not None, BK=BLOCK_K, BN=BLOCK_N,
                     num_warps=8)
    counters.record("wanda_partials")
    return out
