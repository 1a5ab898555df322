"""Plain PyTorch versions of the grouped and ragged block-sparse matmuls.

Both run each expert's rows through kernel 1's plain version
(``block_sparse.ref.block_sparse_matmul_ref``), the routine the
per-expert loop path runs too, so a token's row comes out of the three
MoE dispatch paths from the same product of its expert's weight. The
int8 kernels' plain versions are these over ``dequantized_stack``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.block_sparse.ref import (block_mask_from_plan,
                                                  block_sparse_matmul_ref,
                                                  dequantize_plan)


def block_masks_from_plans(counts: torch.Tensor, indices: torch.Tensor,
                           n_kblocks: int) -> torch.Tensor:
    """The (E, K/b, N/b) block maps a stacked plan encodes."""
    return torch.stack([block_mask_from_plan(counts[e], indices[e],
                                             n_kblocks)
                        for e in range(counts.shape[0])])


def dequantized_stack(tiles: torch.Tensor, counts: torch.Tensor,
                      indices: torch.Tensor, slots: torch.Tensor,
                      scales: torch.Tensor, n_kblocks: int) -> tuple:
    """``(w (E, K, N) f32, block maps (E, K/b, N/b))`` of a stacked int8
    plan: the dense stack its kept tiles encode (exact) and its plan's
    block maps, for the plain versions of kernels 6 and 7."""
    w = dequantize_plan(tiles, counts, indices, slots, scales, n_kblocks)
    return w, block_masks_from_plans(counts, indices, n_kblocks)


def grouped_block_sparse_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                                    block_masks: torch.Tensor, block_k: int,
                                    block_n: int,
                                    work: torch.Tensor | None = None,
                                    block_m: int | None = None
                                    ) -> torch.Tensor:
    """y[e] = x[e] @ (w[e] with pruned blocks zeroed). x: (E, M, K);
    w: (E, K, N); block_masks: (E, K/bk, N/bn). With ``work`` (E,
    M/block_m), the rows of every (expert, M-block) whose entry is 0 are
    zeros, as the kernel writes them."""
    E, M, _ = x.shape
    y = torch.zeros((E, M, w.shape[2]), dtype=x.dtype, device=x.device)
    live = (torch.ones((E, 1), dtype=torch.bool) if work is None
            else (work > 0).cpu())
    block_m = M if work is None else block_m
    for e in range(E):
        if bool(live[e].any()):
            y[e] = block_sparse_matmul_ref(x[e], w[e], block_masks[e],
                                           block_k, block_n)
        if work is not None:
            rows = live[e].repeat_interleave(block_m).to(y.device)
            y[e][~rows] = 0
    return y


def ragged_block_sparse_matmul_ref(x: torch.Tensor, w: torch.Tensor,
                                   tile_expert: torch.Tensor, block_m: int,
                                   block_masks: torch.Tensor, block_k: int,
                                   block_n: int) -> torch.Tensor:
    """Each ``block_m``-row tile of the packed buffer times its owning
    expert's masked weight; dead tiles (``tile_expert < 0``) are zeros.
    Consecutive tiles of one expert (its segment) go through one
    product. x: (M, K); w: (E, K, N); tile_expert: (M/bm,)."""
    y = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                    device=x.device)
    owners = tile_expert.tolist()
    t = 0
    while t < len(owners):
        e, t1 = owners[t], t + 1
        while t1 < len(owners) and owners[t1] == e:
            t1 += 1
        if 0 <= e < w.shape[0]:
            rows = slice(t * block_m, t1 * block_m)
            y[rows] = block_sparse_matmul_ref(x[rows], w[e], block_masks[e],
                                              block_k, block_n)
        t = t1
    return y
