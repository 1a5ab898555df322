"""Mosaic Parameter Ranking Controller (Fig. 5 / Algorithm 1).

Profiles the LLM once over a calibration set and emits the reusable
global rank R_LLM: one profile serves every pruning level p and every
pruning category. The :class:`RankArtifact` lives in memory; saving and
loading it come with the bundle I/O of slice 2.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Iterable, Optional

from repro_torch.common.tree import tree_device, tree_get
from repro_torch.core import calibrate as C
from repro_torch.core import pod
from repro_torch.core.registry import projections
from repro_torch.models.specs import ModelConfig


@dataclasses.dataclass
class RankArtifact:
    """Output of the RC: everything the PC needs."""
    rank: dict                  # {(layer, name): normalised rank}
    anorms: dict                # {(layer, tap): ||A||_2 per channel}
    weights: dict               # {(layer, name): param count}
    n_tokens: int
    profile_seconds: float
    hessians: Optional[dict] = None     # only when sparsegpt requested


def profile_model(params, cfg: ModelConfig,
                  calibration_batches: Iterable,
                  alpha: float = pod.DEFAULT_ALPHA,
                  want_hessians: bool = False,
                  device=None) -> RankArtifact:
    """RC profiling (the pipeline's ``rank`` stage): one calibration pass
    over the model emits the reusable global rank R_LLM. ``device`` is
    where the calibration tokens go (default: the params' device)."""
    if want_hessians:
        raise NotImplementedError(
            "Hessian profiling (sparsegpt) is not ported yet")
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    device = tree_device(params) if device is None else device
    t0 = time.perf_counter()
    stats, n_tokens = C.calibrate(params, cfg, calibration_batches, device,
                                  mode="ssq")
    anorms = C.activation_norms(stats)
    rank = pod.global_rank(params, cfg, anorms, alpha=alpha)
    weights = {p.key: int(tree_get(params, p.path).numel())
               for p in projections(cfg)}
    return RankArtifact(rank=rank, anorms=anorms, weights=weights,
                        n_tokens=n_tokens,
                        profile_seconds=time.perf_counter() - t0)
