"""Causal flash attention in the model's (B, S, H, D) layout: the CUDA
kernel for CUDA tensors, its plain version for CPU tensors."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref
from repro_torch.kernels.no_backward import check_inputs


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D), causal."""
    check_inputs("flash_attention_bshd", q, k, v)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v)
    return kernel.flash_attention(q.contiguous(), k.contiguous(),
                                  v.contiguous())
