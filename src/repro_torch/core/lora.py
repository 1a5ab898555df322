"""LoRA adapters for post-pruning recovery fine-tuning (E4, Fig. 10).

Adapters attach to every projection; only A and B train. ``merge_lora``
folds an adapter into the base weights for deployment, optionally under
the pruning masks so unstructured sparsity is kept.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.common.tree import tree_get, tree_set
from repro_torch.core.registry import projections
from repro_torch.models.specs import ModelConfig


def init_lora(gen: torch.Generator, params, cfg: ModelConfig,
              rank: int = 8) -> dict:
    """``{(layer, name): {'a': (in, r), 'b': (r, out)}}`` per projection
    (an expert stack's: ``(E, in, r)``, ``(E, r, out)``), f32 on
    ``gen``'s device: A from ``gen`` scaled by 1/sqrt(in), B zero, so a
    fresh adapter leaves the model unchanged."""
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    adapters = {}
    for proj in projections(cfg):
        shape = tree_get(params, proj.path).shape
        if proj.expert_axis is not None:
            e, cin, cout = shape
            a_shape, b_shape = (e, cin, rank), (e, rank, cout)
        else:
            cin = math.prod(shape[ax] for ax in proj.in_axes)
            cout = math.prod(shape) // cin
            a_shape, b_shape = (cin, rank), (rank, cout)
        adapters[proj.key] = {
            "a": torch.randn(a_shape, generator=gen, device=gen.device)
            / math.sqrt(cin),
            "b": torch.zeros(b_shape, device=gen.device),
        }
    return adapters


def merge_lora(params, cfg: ModelConfig, adapters: dict,
               alpha: float = 16.0, rank: int = 8,
               masks: Optional[dict] = None):
    """Base W + (alpha / rank) A @ B, reshaped to W's layout, for every
    projection with an adapter; a new tree (the untouched leaves are
    shared). With ``masks`` the delta is zeroed where the mask is False.
    Differentiable in the adapters."""
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    scale = alpha / rank
    for proj in projections(cfg):
        if proj.key not in adapters:
            continue
        ab = adapters[proj.key]
        w = tree_get(params, proj.path)
        if proj.expert_axis is not None:
            delta = torch.einsum("eir,ero->eio", ab["a"], ab["b"]) * scale
        else:
            delta = (ab["a"] @ ab["b"] * scale).reshape(w.shape)
        if masks is not None and proj.key in masks:
            delta = torch.where(masks[proj.key].to(delta.device), delta,
                                torch.zeros((), device=delta.device))
        params = tree_set(params, proj.path, w + delta.to(w.dtype))
    return params
