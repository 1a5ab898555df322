"""ServeConfig: the one construction surface both serving engines share.

The port's counterpart of ``repro/serve/config.py`` with torch dtypes
and the same validation. There is no ``interpret`` flag: the tensors'
device decides whether a kernel launches (CUDA) or its plain version
runs (CPU). ``block_size`` selects the continuous engine's KV pool:
``None`` keeps the contiguous per-slot pool, an int switches to the
paged pool (fixed-size KV blocks + per-request block tables, prefix
sharing, chunked prefill — see ``repro_torch.serve.paging``).
``group_experts`` / ``ragged_moe`` pick the MoE expert matmuls' path
and ``quant`` the weight storage the kernels stream (None follows the
flags the plans carry).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine-construction knobs shared by ``Engine`` and
    ``ContinuousEngine`` (fields irrelevant to an engine are ignored by
    it — the static engine has no slots or prefill buckets)."""

    max_slots: int = 4              # concurrent sequences (continuous)
    max_seq: int = 256              # per-sequence KV capacity, tokens
    block_size: Optional[int] = None  # None = contiguous pool; int = paged
    n_blocks: Optional[int] = None  # paged arena size; None = the byte
    #                                 budget of the contiguous pool
    #                                 (max_slots * max_seq / block_size)
    compute_dtype: torch.dtype = torch.bfloat16
    cache_dtype: torch.dtype = torch.bfloat16
    prefill_multiple: int = 16      # prompt right-pad bucket
    prefill_chunk: Optional[int] = None  # paged: split prompts into
    #                                 chunks of this many tokens that
    #                                 interleave with decode ticks
    #                                 (block_size multiple); None = one
    #                                 prefill per prompt
    group_experts: Optional[bool] = None  # MoE: grouped one-launch
    #                                 kernel (None follows plan flags)
    ragged_moe: Optional[bool] = None  # MoE: ragged (routed-tokens-only)
    #                                 dispatch at decode batch sizes
    #                                 (None follows plan flags)
    quant: Optional[str] = None     # projection weight storage: "int8"
    #                                 streams the plans' kept-tile int8
    #                                 storage (needs an int8 pack),
    #                                 "none" forces the dequantised
    #                                 reference path, None follows plan
    #                                 flags
    paged_kernel: bool = False      # paged decode: the paged-attention
    #                                 kernel instead of the gather path
    #                                 (needs block_size)
    scheduler: str = "fifo"         # admission policy name from
    #                                 repro_torch.serve.policies.SCHEDULERS:
    #                                 fifo | priority | slo

    def __post_init__(self):
        from repro_torch.core.recipe import QUANT_MODES
        from repro_torch.serve.policies import SCHEDULERS
        if self.quant is not None and self.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant {self.quant!r}; "
                             f"choices: {QUANT_MODES} or None")
        if self.max_seq <= 0:
            raise ValueError(f"max_seq={self.max_seq} must be positive")
        for name in ("compute_dtype", "cache_dtype"):
            if not getattr(self, name).is_floating_point:
                raise ValueError(f"{name} must be a floating dtype")
        if self.scheduler not in SCHEDULERS:
            raise ValueError(f"unknown scheduler {self.scheduler!r}; "
                             f"registered: {SCHEDULERS.names()}")
        if self.block_size is not None:
            if self.max_seq % self.block_size:
                raise ValueError(
                    f"max_seq {self.max_seq} must be a multiple of "
                    f"block_size {self.block_size} (the paged view must "
                    "match the contiguous pool width exactly)")
            if (self.prefill_chunk is not None
                    and self.prefill_chunk % self.block_size):
                raise ValueError(
                    f"prefill_chunk {self.prefill_chunk} must be a "
                    f"multiple of block_size {self.block_size}")
        elif self.prefill_chunk is not None:
            raise ValueError("prefill_chunk needs a paged pool "
                             "(set block_size)")
        if self.paged_kernel and self.block_size is None:
            raise ValueError("paged_kernel needs a paged pool "
                             "(set block_size)")

    # ------------------------------------------------------------ paged

    @property
    def paged(self) -> bool:
        return self.block_size is not None

    @property
    def blocks_per_seq(self) -> int:
        """Block-table width: logical blocks covering ``max_seq``."""
        return self.max_seq // self.block_size

    @property
    def arena_blocks(self) -> int:
        """Usable arena blocks (the scratch block is extra). Defaults to
        the contiguous pool's exact token capacity, so paged-vs-
        contiguous comparisons are at the same cache-arena byte
        budget."""
        if self.n_blocks is not None:
            return self.n_blocks
        return -(-self.max_slots * self.max_seq // self.block_size)
