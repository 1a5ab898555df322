"""Unstructured projection pruning: per-projection masks at POD targets.

Selectors:
  magnitude   — |W|
  wanda       — |W| · ||A||_2  (Eq. 5 metric; the paper's ranking metric)
  wanda_block — the Eq. 5 metric summed over (block x block) tiles; whole
                tiles are pruned, so the block-sparse kernel skips them
  sparsegpt   — not ported yet

Masked weights are exactly zero; mask counts use floor(target·numel) so
the achieved sparsity is exact and idempotent. Sorts are stable, as
``jnp.argsort`` is, so ties break the same way as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.common.tree import tree_get, tree_set
from repro_torch.core.pod import weight_metric
from repro_torch.core.registry import (SELECTORS, Projection, projections,
                                       register_category, register_selector)
from repro_torch.models.specs import ModelConfig


def mask_from_scores(scores: torch.Tensor, target: float) -> torch.Tensor:
    """Keep the highest-scoring (1-target) fraction. Exact count semantics."""
    flat = scores.reshape(-1).float()
    k_prune = int(target * flat.numel())
    if k_prune <= 0:
        return torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    if k_prune >= flat.numel():
        return torch.zeros(scores.shape, dtype=torch.bool,
                           device=scores.device)
    order = torch.argsort(flat, stable=True)                 # ascending
    mask_flat = torch.ones(flat.numel(), dtype=torch.bool,
                           device=scores.device)
    mask_flat[order[:k_prune]] = False
    return mask_flat.reshape(scores.shape)


def block_mask_from_metric(scores: torch.Tensor, target: float,
                           block: int = 16) -> torch.Tensor:
    """Semi-structured mask: prune whole (block x block) tiles with the
    lowest aggregate metric; every pruned tile is a tile the block-sparse
    kernel skips."""
    s2 = scores.reshape(scores.shape[0], -1) if scores.dim() != 2 else scores
    K, N = s2.shape
    Kb, Nb = K // block, N // block
    if Kb == 0 or Nb == 0:
        return mask_from_scores(scores, target)
    trimmed = s2[:Kb * block, :Nb * block]
    tiles = trimmed.reshape(Kb, block, Nb, block).sum(dim=(1, 3))
    tile_mask = mask_from_scores(tiles, target)
    full = tile_mask.repeat_interleave(block, 0).repeat_interleave(block, 1)
    out = torch.ones((K, N), dtype=torch.bool, device=scores.device)
    out[:Kb * block, :Nb * block] = full
    return out.reshape(scores.shape)


def per_output_mask(scores: torch.Tensor, target: float,
                    in_axes: tuple) -> torch.Tensor:
    """Wanda-style: prune the lowest fraction *within each output neuron*."""
    ndim = scores.dim()
    in_ax = tuple(a % ndim for a in in_axes)
    perm = list(in_ax) + [a for a in range(ndim) if a not in in_ax]
    s = scores.permute(perm)
    in_dim = 1
    for a in in_ax:
        in_dim *= scores.shape[a]
    s2 = s.reshape(in_dim, -1)
    k_prune = int(target * in_dim)
    if k_prune <= 0:
        m2 = torch.ones_like(s2, dtype=torch.bool)
    else:
        order = torch.argsort(s2, dim=0, stable=True)
        rank = torch.argsort(order, dim=0, stable=True)   # rank of each entry
        m2 = rank >= k_prune
    m = m2.reshape(s.shape)
    inv = [0] * ndim
    for i, a in enumerate(perm):
        inv[a] = i
    return m.permute(inv)


def score_projection(w: torch.Tensor, proj: Projection, selector: str,
                     anorms: Optional[dict]) -> torch.Tensor:
    if selector == "magnitude":
        return w.float().abs()
    if selector == "wanda":
        if anorms is None:
            raise ValueError("wanda selector needs activation norms")
        return weight_metric(w, anorms[(proj.layer, proj.tap)], proj)
    raise ValueError(f"unknown selector {selector!r}")


@dataclasses.dataclass
class SelectorContext:
    """Side inputs a selector may need (from the RC artifact / recipe)."""
    anorms: Optional[dict] = None
    hessians: Optional[dict] = None
    per_output: bool = False
    block: int = 16              # mask tile for block selectors


def _mask_and_zero(w, scores, target, proj, ctx: SelectorContext):
    if ctx.per_output:
        mask = per_output_mask(scores, target, proj.in_axes)
    else:
        mask = mask_from_scores(scores, target)
    return torch.where(mask, w, torch.zeros_like(w)), mask


@register_selector("magnitude")
def _sel_magnitude(w, proj, target, ctx):
    return _mask_and_zero(w, w.float().abs(), target, proj, ctx)


@register_selector("wanda")
def _sel_wanda(w, proj, target, ctx):
    return _mask_and_zero(w, score_projection(w, proj, "wanda", ctx.anorms),
                          target, proj, ctx)


@register_selector("wanda_block")
def _sel_wanda_block(w, proj, target, ctx):
    scores = score_projection(w, proj, "wanda", ctx.anorms)
    # mask tile == pack tile, so every pruned tile is a skipped tile
    if proj.expert_axis is not None:
        # per-expert tiles: the pack stage plans each expert's 2-D fold
        # independently, so the mask tiles each expert independently too
        mask = torch.stack([
            block_mask_from_metric(scores[e], target, block=ctx.block)
            for e in range(scores.shape[0])])
    else:
        mask = block_mask_from_metric(scores, target, block=ctx.block)
    return torch.where(mask, w, torch.zeros_like(w)), mask


@register_selector("sparsegpt")
def _sel_sparsegpt(w, proj, target, ctx):
    raise NotImplementedError("the sparsegpt selector is not ported yet")


def prune_unstructured(params, cfg: ModelConfig, targets: dict,
                       selector: str = "wanda",
                       anorms: Optional[dict] = None,
                       hessians: Optional[dict] = None,
                       per_output: bool = False,
                       block: int = 16):
    """Apply per-projection masks. Returns (new_params, masks).

    targets: {(layer, name): fraction}. ``selector`` names an entry in
    ``registry.SELECTORS``. ``block`` is the tile size for block
    selectors — keep it equal to the serving kernel's pack block.
    """
    sel = SELECTORS.get(selector)
    ctx = SelectorContext(anorms=anorms, hessians=hessians,
                          per_output=per_output, block=block)
    masks: dict = {}
    for proj in projections(cfg):
        w = tree_get(params, proj.path)
        new_w, mask = sel(w, proj, targets.get(proj.key, 0.0), ctx)
        params = tree_set(params, proj.path, new_w.to(w.dtype))
        masks[proj.key] = mask
    return params, masks


@register_category("unstructured")
def _category_unstructured(params, cfg, targets, artifact, recipe):
    """Mask-only pruning: quality-first, shapes unchanged."""
    params, masks = prune_unstructured(
        params, cfg, targets, selector=recipe.selector,
        anorms=artifact.anorms, hessians=artifact.hessians,
        per_output=recipe.per_output, block=recipe.block)
    return params, cfg, {"unstructured_sparsity": achieved_sparsity(masks)}


def achieved_sparsity(masks: dict) -> float:
    total = sum(int(m.numel()) for m in masks.values())
    zeros = sum(int(m.numel()) - int(m.sum()) for m in masks.values())
    return zeros / max(total, 1)
