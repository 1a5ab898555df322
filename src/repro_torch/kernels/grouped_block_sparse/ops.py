"""The grouped (all experts in one launch) and ragged (routed tokens
only) block-sparse matmuls: plan stacking from independent per-expert
plans, the occupancy reductions, and the ops that dispatch to the CUDA
kernels (CUDA tensors) or their plain versions (CPU tensors).

The ``quant_*`` ops run the same launches over int8 kept-tile storage
(every expert's kept tiles in one array, absolute slots, pow2 scales).
Each CUDA launch also adds the experts it computed to a device-side
counter (``*_experts_computed``), as the JAX package's ops record them,
without a host sync.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import counters
from repro_torch.kernels.grouped_block_sparse import kernel, ref
from repro_torch.kernels.no_backward import check_inputs

# Above this many slot rows a grouped panel is tiled by the plan block
# instead of kept whole (the JAX package's VMEM-driven threshold; kept so
# the occupancy map, and the experts-computed count, are the same).
PANEL_ROWS_MAX = 1024

# M-tile height of the ragged kernel: per-expert segments start on
# multiples of it, so every tile belongs to one expert.
RAGGED_BLOCK_ROWS = kernel.TILE_ROWS


def stack_expert_plans(counts_e, indices_e) -> tuple:
    """Stack per-expert ``plan_blocks`` outputs into the rectangular
    (counts (E, nN), indices (E, nN, max_nnz)) arrays the grouped kernel
    consumes: index rows are edge-padded to the max ``max_nnz`` across
    experts (padded steps are masked on ``counts``)."""
    counts_e = [np.asarray(c) for c in counts_e]
    indices_e = [np.asarray(i) for i in indices_e]
    max_nnz = max(idx.shape[1] for idx in indices_e)
    indices_e = [np.pad(idx, ((0, 0), (0, max_nnz - idx.shape[1])),
                        mode="edge") for idx in indices_e]
    return np.stack(counts_e), np.stack(indices_e)


def occupancy(row_live: torch.Tensor | None, E: int, M: int,
              block_m: int, device) -> tuple:
    """``(work (E, M/block_m) int32, experts computed)``: which (expert,
    M-block) pairs hold a live row, and how many experts hold any. No
    ``row_live`` marks every block live (E experts computed)."""
    n_mblocks = M // block_m
    if row_live is None:
        work = torch.ones((E, n_mblocks), dtype=torch.int32, device=device)
        return work, torch.tensor(E, device=device)
    live = row_live.reshape(E, n_mblocks, block_m).any(-1)
    return live.to(torch.int32), live.any(-1).sum()


def ragged_occupancy(tile_expert: torch.Tensor, E: int) -> torch.Tensor:
    """Experts owning at least one live tile (a 0-d device tensor)."""
    owner = torch.where(tile_expert >= 0, tile_expert,
                        torch.full_like(tile_expert, E)).long()
    hit = torch.zeros(E + 1, dtype=torch.int32, device=tile_expert.device)
    return hit.index_fill_(0, owner, 1)[:E].sum()


def grouped_blocksparse_matmul(x: torch.Tensor, w: torch.Tensor,
                               counts: torch.Tensor, indices: torch.Tensor,
                               block: int, block_m: int | None = None,
                               row_live: torch.Tensor | None = None
                               ) -> torch.Tensor:
    """y[e] = x[e] @ w[e] for all experts in one launch, visiting nonzero
    weight blocks only. x: (E, M, K); w: (E, K, N). ``block_m=None``
    keeps each expert's whole M panel as one occupancy block; an
    explicit ``block_m`` tiles M for prefill-sized panels. ``row_live``
    (optional, (E, M) bool): per-row occupancy from the router; (expert,
    M-block) pairs with no live row are written as zeros without being
    computed. A CUDA ``x`` launches the kernel (or raises); a CPU ``x``
    runs the plain version."""
    check_inputs("grouped_blocksparse_matmul", x, w, counts, indices,
                 row_live)
    E, M, _ = x.shape
    block_m = M if block_m is None else block_m
    work, experts = occupancy(row_live, E, M, block_m, x.device)
    if x.device.type == "cpu":
        masks = ref.block_masks_from_plans(counts, indices,
                                           w.shape[1] // block)
        return ref.grouped_block_sparse_matmul_ref(
            x, w, masks, block, block, work=work, block_m=block_m)
    y = kernel.grouped_block_sparse_matmul(x, w, counts, indices, work,
                                           block, block_m)
    counters.record_device("grouped_block_sparse_experts_computed", experts)
    return y


def quant_grouped_blocksparse_matmul(x: torch.Tensor, tiles: torch.Tensor,
                                     counts: torch.Tensor,
                                     indices: torch.Tensor,
                                     slots: torch.Tensor,
                                     scales: torch.Tensor, block: int,
                                     block_m: int | None = None,
                                     row_live: torch.Tensor | None = None
                                     ) -> torch.Tensor:
    """The grouped launch over int8 kept-tile storage (``block_m`` and
    ``row_live`` as in :func:`grouped_blocksparse_matmul`). tiles:
    (T, b, b) int8; slots (E, nN, max_nnz) int32 absolute rows; scales
    (E, nN, max_nnz) f32. A CPU ``x`` runs kernel 6's plain version over
    the dequantised stack."""
    check_inputs("quant_grouped_blocksparse_matmul", x, tiles, counts,
                 indices, slots, scales, row_live)
    E, M, _ = x.shape
    block_m = M if block_m is None else block_m
    work, experts = occupancy(row_live, E, M, block_m, x.device)
    if x.device.type == "cpu":
        w, masks = ref.dequantized_stack(tiles, counts, indices, slots,
                                         scales, x.shape[2] // block)
        return ref.grouped_block_sparse_matmul_ref(
            x, w.to(x.dtype), masks, block, block, work=work,
            block_m=block_m)
    y = kernel.quant_grouped_block_sparse_matmul(
        x, tiles, counts, indices, slots, scales, work, block, block_m)
    counters.record_device("grouped_block_sparse_quant_experts_computed",
                           experts)
    return y


def quant_ragged_blocksparse_matmul(x: torch.Tensor, tiles: torch.Tensor,
                                    counts: torch.Tensor,
                                    indices: torch.Tensor,
                                    slots: torch.Tensor,
                                    scales: torch.Tensor,
                                    tile_expert: torch.Tensor,
                                    block: int) -> torch.Tensor:
    """The ragged launch over int8 kept-tile storage (operands as in
    :func:`quant_grouped_blocksparse_matmul`). A CPU ``x`` runs kernel
    7's plain version over the dequantised stack."""
    check_inputs("quant_ragged_blocksparse_matmul", x, tiles, counts,
                 indices, slots, scales, tile_expert)
    tile_expert = tile_expert.to(torch.int32)
    if x.device.type == "cpu":
        w, masks = ref.dequantized_stack(tiles, counts, indices, slots,
                                         scales, x.shape[1] // block)
        return ref.ragged_block_sparse_matmul_ref(
            x, w.to(x.dtype), tile_expert, RAGGED_BLOCK_ROWS, masks, block,
            block)
    y = kernel.quant_ragged_block_sparse_matmul(
        x, tiles, counts, indices, slots, scales, tile_expert.contiguous(),
        block)
    counters.record_device(
        "grouped_block_sparse_ragged_quant_experts_computed",
        ragged_occupancy(tile_expert, counts.shape[0]))
    return y


def ragged_blocksparse_matmul(x: torch.Tensor, w: torch.Tensor,
                              counts: torch.Tensor, indices: torch.Tensor,
                              tile_expert: torch.Tensor,
                              block: int) -> torch.Tensor:
    """The ragged expert batch (routed tokens packed into 16-row-aligned
    per-expert segments) through every owning expert's tile plan, one
    launch sized by the packed buffer rather than E x capacity.
    ``tile_expert`` maps each 16-row tile to its expert (-1: a dead
    padding tile, written as zeros)."""
    check_inputs("ragged_blocksparse_matmul", x, w, counts, indices,
                 tile_expert)
    tile_expert = tile_expert.to(torch.int32)
    if x.device.type == "cpu":
        masks = ref.block_masks_from_plans(counts, indices,
                                           w.shape[1] // block)
        return ref.ragged_block_sparse_matmul_ref(
            x, w, tile_expert, RAGGED_BLOCK_ROWS, masks, block, block)
    y = kernel.ragged_block_sparse_matmul(x, w, counts, indices,
                                          tile_expert.contiguous(), block)
    counters.record_device("grouped_block_sparse_ragged_experts_computed",
                           ragged_occupancy(tile_expert, w.shape[0]))
    return y
