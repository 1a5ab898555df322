"""Paged decode attention in the decode step's (B, 1, H, D) layout:
the CUDA kernel for CUDA tensors, its plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.no_backward import check_inputs
from repro_torch.kernels.paged_attention import kernel, ref


def paged_attention_decode(q: torch.Tensor, k_arena: torch.Tensor,
                           v_arena: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, 1, Hq, D); k/v arena: (n_blocks + 1, bs, Hkv, D);
    block_tables: (B, max_blocks); lengths: (B,) -> (B, 1, Hq, D)."""
    check_inputs("paged_attention_decode", q, k_arena, v_arena,
                 block_tables, lengths)
    if q.shape[1] != 1:
        raise ValueError(f"paged_attention is decode-only (S=1), got "
                         f"S={q.shape[1]}")
    tables = block_tables.to(torch.int32)
    lengths = lengths.to(torch.int32)
    if q.device.type == "cpu":
        out = ref.paged_attention_ref(q[:, 0], k_arena, v_arena, tables,
                                      lengths)
    else:
        out = kernel.paged_attention(q[:, 0].contiguous(), k_arena,
                                     v_arena, tables.contiguous(),
                                     lengths.contiguous())
    return out[:, None]
