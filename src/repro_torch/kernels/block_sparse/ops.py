"""Block-sparse matmul: block plans from pruned weights, and the op that
dispatches to the CUDA kernel (CUDA tensors) or its plain version (CPU
tensors)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.block_sparse import kernel, ref


def block_mask_from_weight_mask(mask: torch.Tensor, block_k: int,
                                block_n: int) -> torch.Tensor:
    """Elementwise keep-mask (..., K, N) -> block-level nonzero map
    (..., K/bk, N/bn), on the mask's device (leading axes, such as an
    expert stack's, are kept)."""
    *lead, K, N = mask.shape
    if K % block_k or N % block_n:
        raise ValueError(f"mask {tuple(mask.shape)} does not tile by "
                         f"({block_k}, {block_n})")
    m = mask.reshape(*lead, K // block_k, block_k, N // block_n, block_n)
    return m.any(dim=-1).any(dim=-2)


def plan_blocks(block_mask) -> tuple:
    """Block map (host) -> numpy ``(counts (nN,), indices (nN, max_nnz))``
    int32. Index rows are edge-padded with their last live id (id 0 for
    an empty column), as the TPU plan is; the CUDA kernel never reads a
    padded step."""
    bm = np.asarray(block_mask)
    nK, nN = bm.shape
    counts = bm.sum(axis=0).astype(np.int32)
    max_nnz = max(int(counts.max()), 1)
    indices = np.zeros((nN, max_nnz), np.int32)
    for n in range(nN):
        nz = np.nonzero(bm[:, n])[0]
        if len(nz) == 0:
            nz = np.array([0])
        pad = np.full(max_nnz - min(len(nz), max_nnz), nz[-1])
        indices[n] = np.concatenate([nz[:max_nnz], pad])
    return counts, indices


def blocksparse_matmul(x: torch.Tensor, w: torch.Tensor,
                       counts: torch.Tensor, indices: torch.Tensor,
                       block: int) -> torch.Tensor:
    """y = x @ w visiting nonzero weight blocks only. A CUDA ``x``
    launches the kernel (or raises); a CPU ``x`` runs the plain
    version."""
    if x.device.type == "cpu":
        bmask = ref.block_mask_from_plan(counts, indices,
                                         w.shape[0] // block)
        return ref.block_sparse_matmul_ref(x, w, bmask, block, block)
    return kernel.block_sparse_matmul(x, w, counts, indices, block)
