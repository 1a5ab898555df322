"""PrunedArtifact: the prune-time -> serve-time bundle, in memory.

Everything the serving stack needs to run a Mosaic-pruned model: the
pruned params, the post-pruning :class:`ModelConfig`, the per-projection
targets, the block-sparse ``PackedProjection`` plans, the driving
:class:`PruneRecipe`, and a provenance/timing report. The on-disk layout
(``save``/``load``) comes with the bundle I/O of slice 2.
"""
from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch.core.recipe import PruneRecipe
from repro_torch.models.specs import ModelConfig


@dataclasses.dataclass
class PrunedArtifact:
    params: Any
    cfg: ModelConfig
    recipe: PruneRecipe
    targets: dict                 # {(layer, name): sparsity target}
    packed: dict                  # {(layer, name): PackedProjection}
    report: dict                  # JSON-safe provenance + timings
    info: dict = dataclasses.field(default_factory=dict)
