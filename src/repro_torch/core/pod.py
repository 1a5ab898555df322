"""Projection Outlier Distribution (POD) — Eqs. 5-6 and Algorithm 1.

For each projection m in layer n:
    ω_{n,m}  = ||A_n||_2 · |θ_{n,m}|                      (Eq. 5)
    outlier  = ω^i > α · mean(ω_{n,m})                    (Eq. 6)
    R_{n,m}  = 100 · #outliers / #params                  (Alg. 1 l.15)
The normalised R_LLM is the *global rank*: projection importance
comparable across the whole model. Higher rank (more outliers) => more
important => pruned less.

:func:`global_rank` folds each projection to 2-D and scores it with the
Wanda-metric kernel (``kernels/wanda_metric``); on CPU tensors that op
runs its plain version, which computes exactly
``outlier_ratio(weight_metric(...))``. An MoE expert stack ``(E, in,
out)`` folds to ``(E·in, out)`` with its ``(E, in)`` norms flattened:
the ratio counts outliers over all its experts at once, or expert by
expert with ``per_expert``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import tree_get
from repro_torch.core.registry import Projection, projections
from repro_torch.kernels.wanda_metric import ops as wanda_ops
from repro_torch.models.specs import ModelConfig

DEFAULT_ALPHA = 5.0


def weight_metric(w: torch.Tensor, anorm: torch.Tensor,
                  proj: Projection) -> torch.Tensor:
    """Eq. 5 elementwise: |W| scaled by the input-channel activation norm."""
    w = w.float().abs()
    if proj.expert_axis is not None:
        # w: (E, in, out), anorm: (E, in)
        return w * anorm[:, :, None]
    if proj.in_axes == (0,):
        shape = [w.shape[0]] + [1] * (w.dim() - 1)
        return w * anorm.reshape(shape)
    if proj.in_axes == (0, 1):
        # o-projection (H, D, d), anorm (H, D)
        return w * anorm[:, :, None]
    raise ValueError(f"unsupported in_axes {proj.in_axes}")


def outlier_ratio(metric: torch.Tensor,
                  alpha: float = DEFAULT_ALPHA) -> torch.Tensor:
    """Eq. 6 within one projection: fraction of ω above α·mean(ω), in %."""
    flat = metric.reshape(-1)
    return 100.0 * (flat > alpha * flat.mean()).float().mean()


def fold_2d(w: torch.Tensor, anorm: torch.Tensor,
            proj: Projection) -> tuple:
    """A dense projection as ``(w2 (K, N), anorm (K,))``: input axes
    first and flattened, output axes flattened. ``in_axes (0,)`` gives
    ``(w.shape[0], -1)``; the o-projection ``(H, D, d)`` gives
    ``(H·D, d)`` with anorm ``(H·D,)``; an expert stack ``(E, in, out)``
    with anorm ``(E, in)`` gives ``(E·in, out)`` with anorm ``(E·in,)``."""
    if proj.expert_axis is not None:
        return w.reshape(w.shape[0] * w.shape[1], -1), anorm.reshape(-1)
    if proj.in_axes == (0,):
        return w.reshape(w.shape[0], -1), anorm
    if proj.in_axes == (0, 1):
        return w.reshape(w.shape[0] * w.shape[1], -1), anorm.reshape(-1)
    raise ValueError(f"unsupported in_axes {proj.in_axes}")


def global_rank(params, cfg: ModelConfig, anorms: dict,
                alpha: float = DEFAULT_ALPHA,
                per_expert: bool = False) -> dict:
    """Algorithm 1: the Mosaic Parameter Ranking Controller core.

    Returns {(layer, proj_name): normalised rank}. Normalisation maps the
    outlier ratios to mean 1.0 so the planner composes with any p. An
    expert stack gets one rank over all its experts, or with
    ``per_expert`` an (E,) array of ranks, one per expert.
    """
    raw: dict = {}
    for proj in projections(cfg):
        w = tree_get(params, proj.path)
        anorm = anorms[(proj.layer, proj.tap)]
        if proj.expert_axis is not None and per_expert:
            raw[proj.key] = np.array([
                float(wanda_ops.outlier_ratio(w[e].contiguous(), anorm[e],
                                              alpha))
                for e in range(w.shape[0])])
            continue
        w2, a2 = fold_2d(w, anorm, proj)
        raw[proj.key] = float(wanda_ops.outlier_ratio(w2.contiguous(), a2,
                                                      alpha))
    return normalize_rank(raw)


def normalize_rank(raw: dict) -> dict:
    """Rank Post-Processor (Fig. 5 step 6): scale ranks to mean 1.0."""
    vals = []
    for v in raw.values():
        vals.extend(np.atleast_1d(v).tolist())
    mean = float(np.mean(vals)) if vals else 1.0
    if mean <= 0:
        return {k: np.ones_like(np.asarray(v, dtype=np.float64)) if np.ndim(v)
                else 1.0 for k, v in raw.items()}
    return {k: (np.asarray(v, np.float64) / mean if np.ndim(v) else v / mean)
            for k, v in raw.items()}


def layer_rank(rank: dict) -> dict:
    """Collapse a projection rank to per-layer ranks (the OWL/LOD baseline)."""
    by_layer: dict[int, list] = {}
    for (layer, _), v in rank.items():
        by_layer.setdefault(layer, []).extend(np.atleast_1d(v).tolist())
    return {layer: float(np.mean(v)) for layer, v in by_layer.items()}
