"""ServeConfig: the engine-construction knobs of the static engine.

The port's counterpart of ``repro/serve/config.py`` with torch dtypes.
There is no ``interpret`` flag: the tensors' device decides whether a
kernel launches (CUDA) or its plain version runs (CPU). The continuous
engine's fields (slots, paging, prefill chunks, schedulers) and the MoE
and int8 knobs come with the slices that port them.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_seq: int = 256              # per-sequence KV capacity, tokens
    compute_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.max_seq <= 0:
            raise ValueError(f"max_seq={self.max_seq} must be positive")
        for name in ("compute_dtype", "cache_dtype"):
            if not getattr(self, name).is_floating_point:
                raise ValueError(f"{name} must be a floating dtype")
