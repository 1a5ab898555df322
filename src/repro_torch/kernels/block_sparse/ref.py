"""Plain PyTorch version of the block-sparse matmul."""
from __future__ import annotations

import torch


def block_sparse_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                            block_mask: torch.Tensor, block_k: int,
                            block_n: int) -> torch.Tensor:
    """y = x @ (w with pruned blocks zeroed). block_mask: (K/bk, N/bn)."""
    mask = block_mask.repeat_interleave(block_k, 0).repeat_interleave(
        block_n, 1)
    return x @ torch.where(mask, w, torch.zeros_like(w))


def block_mask_from_plan(counts: torch.Tensor, indices: torch.Tensor,
                         n_kblocks: int) -> torch.Tensor:
    """The (K/b, N/b) block map a plan encodes: column ``n`` keeps
    K-blocks ``indices[n, :counts[n]]`` (padded steps are ignored)."""
    nN, max_nnz = indices.shape
    live = (torch.arange(max_nnz, device=indices.device)[None, :]
            < counts[:, None])
    mask = torch.zeros((n_kblocks, nN), dtype=torch.bool,
                       device=indices.device)
    cols = torch.arange(nN, device=indices.device)[:, None].expand(
        nN, max_nnz)
    mask[indices.long()[live], cols[live]] = True
    return mask
