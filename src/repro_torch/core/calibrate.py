"""Calibration pass: per-projection input-activation statistics.

Runs the calibration set through the model once and accumulates, for
every projection input, the per-channel sum of squares; its square root
is Eq. 5's ``||A_n||_2``. This is the Mosaic RC's "LLM Profiler" +
"Activation Processor" (Fig. 5, steps 2-4). Only the ``ssq`` mode is
ported; Gram (Hessian) statistics come with the sparsegpt selector.
"""
from __future__ import annotations

from typing import Iterable

import torch

from repro_torch.core.registry import tap_sequence
from repro_torch.models import taps
from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig


def _forward_stats(params, cfg: ModelConfig, tokens: torch.Tensor,
                   mode: str) -> dict:
    """One batch -> {(layer, tap_name): stat}."""
    with taps.collecting(mode) as collected:
        T.forward(params, cfg, tokens, compute_dtype=torch.float32)
    out = {}
    idx = 0
    for i, spec in enumerate(cfg.layers()):
        for name in tap_sequence(spec):
            got_name, stat = collected[idx]
            if got_name != name:
                raise RuntimeError(f"tap mismatch {got_name} != {name}")
            out[(i, name)] = stat
            idx += 1
    if idx != len(collected):
        raise RuntimeError("unconsumed taps")
    return out


@torch.no_grad()
def calibrate(params, cfg: ModelConfig, batches: Iterable, device,
              mode: str = "ssq") -> tuple:
    """Accumulate activation stats over calibration batches (numpy or
    tensor token arrays, moved to ``device``). ``batches`` is consumed
    exactly once. Returns ``(stats, n_tokens)`` with stats
    ``{(layer, tap): per-channel sum of squares}``."""
    total = None
    n_tokens = 0
    for tokens in batches:
        tokens = torch.as_tensor(tokens, device=device).long()
        stats = _forward_stats(params, cfg, tokens, mode)
        n_tokens += tokens.numel()
        if total is None:
            total = stats
        else:
            total = {k: total[k] + v for k, v in stats.items()}
    return total, n_tokens


def activation_norms(stats: dict) -> dict:
    """ssq stats -> per-channel l2 norms (the ||A||_2 of Eq. 5)."""
    return {k: torch.sqrt(v) for k, v in stats.items()}
