"""Artifact-driven pool sizing: size a worker from the bundle's report.

A serving worker deciding how many slots / KV blocks it can afford
needs two numbers: how many bytes the pruned weights occupy and how
many bytes one token of KV cache costs. Both are derivable from a
saved bundle's ``report.json`` (``bytes_after``, ``params_*``) and
``config.json`` (the post-pruning :class:`ModelConfig`) — so placement
reads *only* those two JSON files and never touches the weights. That
makes the sizing decision cheap enough to run per-candidate in a
placement loop (which artifact fits which worker) before any worker
commits to a multi-second weight load.

``plan_placement`` turns an artifact directory plus a memory budget
into a :class:`Placement`: the derived byte accounting and a ready
:class:`~repro_torch.serve.config.ServeConfig` with ``max_slots`` /
``n_blocks`` sized so weights + KV arena + headroom fit the budget.
The port's counterpart of ``repro/serve/gateway/placement.py``: the same
numbers from the same bundle, with torch dtypes for the cache.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Optional

import torch

from repro_torch.models.specs import AttentionSpec, config_from_dict
from repro_torch.serve.config import ServeConfig


def kv_bytes_per_token(cfg, cache_dtype=torch.bfloat16) -> int:
    """KV-cache bytes one token occupies across all attention layers
    (K + V, ``n_kv`` heads each). SSM layers hold recurrent state, not
    per-token cache, so they contribute nothing here."""
    itemsize = torch.empty((), dtype=cache_dtype).element_size()
    total = 0
    for i in range(cfg.n_layers):
        mixer = cfg.layer(i).mixer
        if isinstance(mixer, AttentionSpec):
            total += 2 * mixer.n_kv * mixer.head_dim * itemsize
    return total


@dataclasses.dataclass(frozen=True)
class Placement:
    """One artifact-on-worker sizing decision."""
    artifact: str                   # bundle directory
    memory_bytes: int               # worker budget the plan fits in
    weights_bytes: int              # report.json bytes_after
    density: float                  # params_after / params_before
    kv_token_bytes: int             # KV bytes per cached token
    kv_budget_bytes: int            # budget left for the KV arena
    kv_tokens: int                  # arena capacity, tokens
    serve: ServeConfig              # sized engine construction knobs

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["serve"] = {"max_slots": self.serve.max_slots,
                      "max_seq": self.serve.max_seq,
                      "block_size": self.serve.block_size,
                      "n_blocks": self.serve.n_blocks,
                      "scheduler": self.serve.scheduler}
        return d


def plan_placement(artifact_dir, memory_bytes: int, *,
                   max_seq: int = 256, block_size: Optional[int] = None,
                   max_slots: int = 64, headroom: float = 0.1,
                   cache_dtype=torch.bfloat16,
                   scheduler: str = "fifo",
                   prefill_chunk: Optional[int] = None) -> Placement:
    """Size slot/block pools for ``artifact_dir`` under ``memory_bytes``.

    ``headroom`` reserves a fraction of the budget for activations and
    runtime overhead. ``max_slots`` is a cap — the planned slot count
    is whatever the leftover KV budget supports, at most this. With a
    ``block_size`` the plan sizes a paged arena (``n_blocks``);
    otherwise slots own contiguous ``max_seq`` regions, which needs
    ``kv_tokens >= max_seq`` per slot and therefore admits fewer.
    """
    root = pathlib.Path(artifact_dir)
    report = json.loads((root / "report.json").read_text())
    cfg = config_from_dict(json.loads((root / "config.json").read_text()))
    weights = int(report["bytes_after"])
    density = (report["params_after"] / report["params_before"]
               if report.get("params_before") else 1.0)
    per_tok = kv_bytes_per_token(cfg, cache_dtype)
    if per_tok == 0:
        raise ValueError("config has no attention layers — paged/"
                         "contiguous KV placement does not apply")
    if block_size is not None:
        # mirror ServeConfig's invariants up front: a bad block size
        # must fail with a clear error here, not a ZeroDivisionError
        # (block_size > max_seq) or a late ServeConfig raise
        if block_size > max_seq or max_seq % block_size:
            raise ValueError(
                f"block_size {block_size} must divide max_seq {max_seq} "
                "(the paged view must match the contiguous pool width "
                "exactly)")
    kv_budget = int(memory_bytes * (1.0 - headroom)) - weights
    tokens = kv_budget // per_tok
    if tokens < max_seq:
        raise ValueError(
            f"memory budget {memory_bytes} cannot hold the weights "
            f"({weights} bytes) plus one {max_seq}-token sequence of KV "
            f"({max_seq * per_tok} bytes at {per_tok} B/token)")
    if block_size is not None:
        # the arena allocates n_blocks + 1 blocks per layer (the +1 is
        # the padding scratch block), so the scratch block's bytes come
        # out of the same budget: a plan sized exactly to memory_bytes
        # must not oversubscribe it
        blocks_per_seq = max_seq // block_size
        n_blocks = tokens // block_size - 1
        if n_blocks < blocks_per_seq:
            raise ValueError(
                f"memory budget {memory_bytes} cannot hold the weights "
                f"({weights} bytes) plus a {max_seq}-token paged arena "
                f"and its scratch block "
                f"({(blocks_per_seq + 1) * block_size * per_tok} bytes)")
        # round the slot cap down to full sequences: a planned slot must
        # always be able to hold max_seq tokens of its own
        slots = max(1, min(max_slots, n_blocks // blocks_per_seq))
        tokens = n_blocks * block_size  # usable capacity (scratch excluded)
        serve = ServeConfig(max_slots=slots, max_seq=max_seq,
                            block_size=block_size, n_blocks=n_blocks,
                            cache_dtype=cache_dtype, scheduler=scheduler,
                            prefill_chunk=prefill_chunk)
    else:
        slots = max(1, min(max_slots, tokens // max_seq))
        tokens = slots * max_seq        # contiguous arena is exact
        serve = ServeConfig(max_slots=slots, max_seq=max_seq,
                            cache_dtype=cache_dtype, scheduler=scheduler)
    return Placement(artifact=str(root), memory_bytes=int(memory_bytes),
                     weights_bytes=weights, density=float(density),
                     kv_token_bytes=per_tok, kv_budget_bytes=kv_budget,
                     kv_tokens=tokens, serve=serve)
