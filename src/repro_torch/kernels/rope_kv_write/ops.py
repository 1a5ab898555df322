"""The paged attention step's prologue (RoPE of q and k, the K/V write
into the paged arenas) in the model's (B, S, H, D) layout: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.no_backward import check_inputs
from repro_torch.kernels.rope_kv_write import kernel, ref


def rope_kv_write(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  k_arena: torch.Tensor, v_arena: torch.Tensor,
                  rows: torch.Tensor, cos: Optional[torch.Tensor] = None,
                  sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, S, n_q, D), k, v (B, S, n_kv, D); arenas (n_blocks + 1, bs,
    n_kv, D); rows (B, S) int64 arena rows; cos, sin (B, S, D / 2) f32,
    or None for no RoPE. Rotates q in place and writes rotated k and v
    into the arenas, in the arenas' dtype; returns q."""
    check_inputs("rope_kv_write", q, k, v, k_arena, v_arena, rows, cos, sin)
    if q.device.type == "cpu":
        return ref.rope_kv_write_ref(q, k, v, k_arena, v_arena, rows, cos,
                                     sin)
    kernel.rope_kv_write(q, k, v, k_arena, v_arena, rows, cos, sin)
    return q
