"""PrunedArtifact: the prune-time -> serve-time bundle.

Everything the serving stack needs to run a Mosaic-pruned model lands in
one directory: the pruned params (through :class:`CheckpointManager`),
the post-pruning :class:`ModelConfig`, the per-projection targets, the
block-sparse ``PackedProjection`` plans, the driving
:class:`PruneRecipe`, and a provenance/timing report. Serve startup
loads the bundle and rehydrates the saved plans: ``pack_model`` never
runs at serve time.

The layout is the JAX package's, file for file, so a bundle saved by
either package loads in the other::

    <dir>/
      step_00000000/arrays.npz  # pruned params (CheckpointManager)
      step_00000000/meta.json
      config.json               # post-pruning ModelConfig
      recipe.json               # the PruneRecipe that produced this
      targets.json              # [[layer, name, target], ...]
      plans.npz + plans.json    # block plans and expert plan stacks
      report.json               # provenance, timings, pack coverage
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.device import resolve_device
from repro_torch.core.recipe import PruneRecipe
from repro_torch.models.specs import (ModelConfig, config_from_dict,
                                      config_to_dict)

RECIPE_FILE = "recipe.json"
CONFIG_FILE = "config.json"
TARGETS_FILE = "targets.json"
REPORT_FILE = "report.json"
PLANS_FILE = "plans.npz"
PLANS_META_FILE = "plans.json"


@dataclasses.dataclass
class PrunedArtifact:
    params: Any
    cfg: ModelConfig
    recipe: PruneRecipe
    targets: dict                 # {(layer, name): sparsity target}
    packed: dict                  # {(layer, name): plan or expert stack}
    report: dict                  # JSON-safe provenance + timings
    info: dict = dataclasses.field(default_factory=dict)  # raw (not saved)

    # --------------------------------------------------------------- save

    def save(self, directory: str) -> str:
        from repro_torch.serve.sparse import plans_to_host
        mgr = CheckpointManager(directory, keep=1)
        mgr.save(0, self.params,
                 extra_meta={"kind": "pruned_artifact",
                             "arch": self.recipe.arch,
                             "category": self.report.get("category")})
        mgr.save_json(RECIPE_FILE, self.recipe.to_dict())
        mgr.save_json(CONFIG_FILE, config_to_dict(self.cfg))
        mgr.save_json(TARGETS_FILE,
                      [[layer, name, t] for (layer, name), t
                       in sorted(self.targets.items())])
        mgr.save_json(REPORT_FILE, self.report)
        arrays, meta = plans_to_host(self.packed)
        mgr.save_arrays(PLANS_FILE, arrays)
        mgr.save_json(PLANS_META_FILE, meta)
        return directory

    # --------------------------------------------------------------- load

    @staticmethod
    def is_artifact(directory: str) -> bool:
        return (os.path.isdir(directory)
                and os.path.exists(os.path.join(directory, RECIPE_FILE))
                and os.path.exists(os.path.join(directory, CONFIG_FILE)))

    @classmethod
    def load(cls, directory: str, device=None) -> "PrunedArtifact":
        """Load a bundle onto ``device`` (``cuda`` unless the caller asks
        for another; raises when CUDA is missing)."""
        from repro_torch.models import transformer as T
        from repro_torch.serve.sparse import plans_from_host
        if not cls.is_artifact(directory):
            raise FileNotFoundError(
                f"{directory!r} is not a PrunedArtifact bundle "
                f"(missing {RECIPE_FILE}/{CONFIG_FILE})")
        device = resolve_device(device)
        mgr = CheckpointManager(directory, keep=1)
        recipe = PruneRecipe.from_dict(mgr.load_json(RECIPE_FILE))
        cfg = config_from_dict(mgr.load_json(CONFIG_FILE))
        # restore into the exact tree the pruned config implies (shapes
        # only: meta tensors, nothing allocated twice)
        params = mgr.restore(T.init_model(None, cfg), device=device)
        targets = {(int(layer), name): float(t)
                   for layer, name, t in mgr.load_json(TARGETS_FILE)}
        packed = {}
        if mgr.has(PLANS_META_FILE):
            packed = plans_from_host(mgr.load_arrays(PLANS_FILE),
                                     mgr.load_json(PLANS_META_FILE), device)
        return cls(params=params, cfg=cfg, recipe=recipe, targets=targets,
                   packed=packed, report=mgr.load_json(REPORT_FILE))
