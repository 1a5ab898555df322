"""Plain PyTorch versions of the block-sparse matmul and of its int8
kept-tile variant."""
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


def dequantize_plan(tiles: torch.Tensor, counts: torch.Tensor,
                    indices: torch.Tensor, slots: torch.Tensor,
                    scales: torch.Tensor, n_kblocks: int) -> torch.Tensor:
    """The dense f32 weight an int8 plan encodes: each live step's tile
    ``tiles[slots[..., n, s]] * scales[..., n, s]`` (exact: pow2 scales)
    at K-block ``indices[..., n, s]`` of column ``n``, zeros elsewhere.
    Plans with leading axes (an expert stack's, slots absolute rows of
    ``tiles``) give (..., K, N)."""
    *lead, nN, max_nnz = indices.shape
    b = tiles.shape[-1]
    dev = tiles.device
    live = (torch.arange(max_nnz, device=dev)
            < counts.to(dev)[..., None].long())
    pos = torch.nonzero(live, as_tuple=True)
    w = torch.zeros((*lead, n_kblocks, nN, b, b), dtype=torch.float32,
                    device=dev)
    vals = tiles[slots.to(dev).long()[live]].float() \
        * scales.to(dev)[live][:, None, None]
    w[(*pos[:-2], indices.to(dev).long()[live], pos[-2])] = vals
    return w.transpose(-3, -2).reshape(*lead, n_kblocks * b, nN * b)


def quant_block_sparse_matmul_ref(x: torch.Tensor, tiles: torch.Tensor,
                                  counts: torch.Tensor,
                                  indices: torch.Tensor,
                                  slots: torch.Tensor, scales: torch.Tensor,
                                  block: int) -> torch.Tensor:
    """Kernel 1's plain version over the dequantised weight, in x's
    dtype (exact in f32 and bf16), so it equals that routine bitwise."""
    n_kblocks = x.shape[-1] // block
    w = dequantize_plan(tiles, counts, indices, slots, scales,
                        n_kblocks).to(x.dtype)
    return block_sparse_matmul_ref(
        x, w, block_mask_from_plan(counts, indices, n_kblocks), block,
        block)
