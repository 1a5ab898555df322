"""Block-sparse matmul: block plans from pruned weights, the int8
kept-tile storage layout (``plan_slots``, ``gather_kept_tiles``), and
the ops that dispatch to the CUDA kernels (CUDA tensors) or their plain
versions (CPU tensors)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.block_sparse import kernel, ref
from repro_torch.kernels.no_backward import check_inputs


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


def plan_slots(counts, max_nnz: int) -> tuple:
    """Compact-tile slot map of the int8 kernels, as the JAX package
    builds it. Kept tiles are stored in plan order (column ``n``'s tiles
    on consecutive storage rows) and ``slots[..., n, s]`` names the row
    of column ``n``'s step-``s`` tile. Steps past ``counts[n]`` clamp to
    the column's last kept tile, empty columns to row 0. ``counts``
    (..., nN) numpy or tensor; leading axes (an expert stack's) plan
    independently, each from row 0. Returns ``(slots (..., nN, max_nnz)
    int32 numpy, total)``: the kept-tile count (an array over the
    leading axes); storage holds ``max(total, 1)`` rows."""
    c = np.asarray(counts.cpu() if torch.is_tensor(counts) else counts,
                   np.int64)
    off = np.cumsum(c, axis=-1) - c
    total = c.sum(axis=-1)
    steps = np.minimum(np.arange(max_nnz),
                       np.maximum(c - 1, 0)[..., None])
    hi = np.expand_dims(np.maximum(total, 1) - 1, (-1, -2))
    slots = np.clip(off[..., None] + steps, 0, hi).astype(np.int32)
    return slots, (total if c.ndim > 1 else int(total))


def gather_kept_tiles(w: torch.Tensor, counts: torch.Tensor,
                      indices: torch.Tensor, block: int) -> torch.Tensor:
    """The kept (block, block) tiles of a planned weight, stacked in plan
    order, on the weight's device: ``w`` (K, N) with plan ``counts``
    (nN,) / ``indices`` (nN, max_nnz), or an expert stack (E, K, N) with
    (E, nN) / (E, nN, max_nnz), whose experts' tiles are concatenated
    expert by expert. Each expert stores ``max(total, 1)`` rows: one
    with no kept tile stores a single zero tile, as the JAX package
    does. Returns (rows, block, block) in ``w``'s dtype: the storage the
    int8 kernels stream instead of the dense weight."""
    stack = w.dim() == 3
    w3 = w if stack else w[None]
    c = (counts if stack else counts[None]).to(w.device).long()
    idx = (indices if stack else indices[None]).to(w.device).long()
    E, K, N = w3.shape
    b = block
    live = (torch.arange(idx.shape[-1], device=w.device)[None, None, :]
            < c[..., None])                             # (E, nN, max_nnz)
    e_of, n_of, _ = torch.nonzero(live, as_tuple=True)  # plan order
    k_of = idx[live]
    tiles = w3.reshape(E, K // b, b, N // b, b)[e_of, k_of, :, n_of, :]
    total = c.sum(dim=-1)                               # (E,)
    rows = total.clamp(min=1)
    start = torch.cumsum(rows, 0) - rows                # each expert's row 0
    first = torch.cumsum(total, 0) - total              # its first live tile
    dest = start[e_of] + torch.arange(e_of.numel(), device=w.device) \
        - first[e_of]
    out = torch.zeros((int(rows.sum()), b, b), dtype=w.dtype,
                      device=w.device)
    out[dest] = tiles
    return out


def blocksparse_matmul(x: torch.Tensor, w: torch.Tensor,
                       counts: torch.Tensor, indices: torch.Tensor,
                       block: int) -> torch.Tensor:
    """y = x @ w visiting nonzero weight blocks only. A CUDA ``x``
    launches the kernel (or raises); a CPU ``x`` runs the plain
    version."""
    check_inputs("blocksparse_matmul", x, w, counts, indices)
    if x.device.type == "cpu":
        bmask = ref.block_mask_from_plan(counts, indices,
                                         w.shape[0] // block)
        return ref.block_sparse_matmul_ref(x, w, bmask, block, block)
    return kernel.block_sparse_matmul(x, w, counts, indices, block)


def quant_blocksparse_matmul(x: torch.Tensor, tiles: torch.Tensor,
                             counts: torch.Tensor, indices: torch.Tensor,
                             slots: torch.Tensor, scales: torch.Tensor,
                             block: int) -> torch.Tensor:
    """y = x @ w with the plan's kept tiles stored as int8 ``tiles``
    (T, b, b) and pow2 ``scales`` (nN, max_nnz), located by ``slots``
    (nN, max_nnz). A CUDA ``x`` launches the kernel (or raises); a CPU
    ``x`` runs the plain version (kernel 1's plain version over the
    dequantised weight)."""
    check_inputs("quant_blocksparse_matmul", x, tiles, counts, indices,
                 slots, scales)
    if x.device.type == "cpu":
        return ref.quant_block_sparse_matmul_ref(x, tiles, counts, indices,
                                                 slots, scales, block)
    return kernel.quant_block_sparse_matmul(x, tiles, counts, indices,
                                            slots, scales, block)
