"""The SSD chunked scan in the model's layout: the CUDA kernel for CUDA
tensors, its plain version for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.no_backward import check_inputs
from repro_torch.kernels.ssd_scan import kernel, ref


def ssd_scan(xt: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, chunk: int,
             h0: Optional[torch.Tensor] = None) -> tuple:
    """xt: (B, L, H, P); da: (B, L, H) f32; Bm, Cm: (B, L, N); h0: None
    or (B, H, P, N) f32. Returns (y (B, L, H, P), final state (B, H, P,
    N) f32)."""
    check_inputs("ssd_scan", xt, da, Bm, Cm, h0)
    if xt.device.type == "cpu":
        return ref.ssd_chunked(xt, da, Bm, Cm, chunk, h0)
    return kernel.ssd_scan(
        xt.contiguous(), da.float().contiguous(), Bm, Cm, chunk,
        None if h0 is None else h0.float().contiguous())
