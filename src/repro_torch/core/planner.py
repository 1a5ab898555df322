"""Projection Planner (Fig. 6 step 8): global rank + pruning target p ->
per-projection sparsity targets p_{n,m} with mean(p_{n,m}) == p (Eqs. 1-2).

Granularities:
  global     — every target = p                       (uniform baseline)
  layer      — one target per layer (OWL/LOD)         (quasi-non-uniform)
  projection — one target per projection (Mosaic POD) (fully non-uniform)
"""
from __future__ import annotations

from typing import Optional

import numpy as np

MAX_TARGET = 0.95


def plan_targets(rank: dict, p: float, spread: float = 0.25,
                 weights: Optional[dict] = None,
                 pmax: float = MAX_TARGET) -> dict:
    """Map normalised ranks (mean 1.0) to targets.

    t = p - s·(r - mean_r): more outliers => smaller target. s is chosen so
    the max deviation is `spread·p`, then targets are clipped and
    iteratively re-centred so the (optionally param-count-weighted) mean is
    exactly p — Eq. 1/2 hold by construction.
    """
    if not 0.0 <= p < 1.0:
        raise ValueError(f"pruning target p={p} outside [0, 1)")
    keys = sorted(rank.keys())
    r = np.array([float(np.mean(rank[k])) for k in keys], np.float64)
    if weights is not None:
        w = np.array([float(weights[k]) for k in keys], np.float64)
        w = w / w.sum()
    else:
        w = np.full(len(keys), 1.0 / max(len(keys), 1), np.float64)

    mean_r = float((r * w).sum())
    dev = r - mean_r
    max_dev = np.abs(dev).max()
    scale = (spread * p / max_dev) if max_dev > 1e-12 else 0.0
    t = p - scale * dev

    # re-centre under clipping so weighted mean == p exactly
    for _ in range(100):
        t = np.clip(t, 0.0, pmax)
        err = p - float((t * w).sum())
        if abs(err) < 1e-12:
            break
        # distribute the error over entries that still have headroom
        room = np.where(err > 0, pmax - t, t)
        movable = (room > 1e-12) & (w > 0)
        if not movable.any():
            break
        t = t + np.where(movable, err * w.sum() / (w * movable).sum(), 0.0)
    t = np.clip(t, 0.0, pmax)
    return {k: float(v) for k, v in zip(keys, t)}


def _layer_targets(rank: dict, p: float, spread: float,
                   weights: Optional[dict]) -> dict:
    from repro_torch.core.pod import layer_rank, normalize_rank
    lr = normalize_rank(layer_rank(rank))
    lw = None
    if weights is not None:
        lw = {}
        for (layer, _), v in weights.items():
            lw[layer] = lw.get(layer, 0.0) + float(v)
    return plan_targets(lr, p, spread, lw)


def plan(rank: dict, p: float, granularity: str = "projection",
         spread: float = 0.25, within_spread: float = 0.1,
         weights: Optional[dict] = None) -> dict:
    """Targets at the requested granularity, keyed by (layer, proj_name).

    Projection granularity is *hierarchical*, per Eqs. 1-2: LOD-style layer
    targets p_n first (mean_n p_n == p, Eq. 1), then each layer's budget is
    split across its projections by their within-layer POD ranks
    (mean_m p_{n,m} == p_n, Eq. 2). This keeps the strong cross-layer
    signal and refines it within the layer.
    """
    if granularity == "global":
        return {k: p for k in rank}
    if granularity == "layer":
        lt = _layer_targets(rank, p, spread, weights)
        return {k: lt[k[0]] for k in rank}
    if granularity == "projection":
        import numpy as np
        lt = _layer_targets(rank, p, spread, weights)
        out = {}
        layers = sorted({k[0] for k in rank})
        for layer in layers:
            keys = [k for k in rank if k[0] == layer]
            sub = {k: float(np.mean(rank[k])) for k in keys}
            m = float(np.mean(list(sub.values())))
            sub = {k: (v / m if m > 0 else 1.0) for k, v in sub.items()}
            w = ({k: weights[k] for k in keys} if weights is not None
                 else None)
            out.update(plan_targets(sub, lt[layer], within_spread, w))
        return out
    raise ValueError(f"unknown granularity {granularity!r}")


def plan_from_recipe(rank: dict, recipe, weights: Optional[dict] = None) -> dict:
    """The pipeline's ``plan`` stage: targets from a declarative recipe."""
    return plan(rank, recipe.p, granularity=recipe.granularity,
                spread=recipe.spread, within_spread=recipe.within_spread,
                weights=weights)
