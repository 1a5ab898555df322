"""Mosaic Parameter Pruning Controller (Fig. 6).

Category selection (PC step 9) and the deployment-platform presets live
here; category *execution* is pluggable — each category registers an
executor in ``repro_torch.core.registry.CATEGORIES`` from its home
module, and the pipeline's ``prune`` stage dispatches by name.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import composite as COMP    # noqa: F401 (registers)
from repro_torch.core import structured as S      # noqa: F401 (registers)
from repro_torch.core import unstructured as U    # noqa: F401 (registers)
from repro_torch.core.recipe import PruneRecipe


@dataclasses.dataclass(frozen=True)
class Platform:
    """Deployment target descriptor (Table I analogue)."""
    name: str
    memory_bytes: int
    has_sparse_accel: bool = False   # block-sparse kernel available
    tp_size: int = 1                 # tensor-parallel alignment requirement


PLATFORMS = {
    "cloud": Platform("cloud", 80 << 30, has_sparse_accel=True, tp_size=16),
    "edge": Platform("edge", 4 << 30),
    "mobile": Platform("mobile", 8 << 30),
}


def select_category(platform: Platform, dense_bytes: int, p: float,
                    structured_share: float = 0.5) -> str:
    """PC step 9: category by available memory (Section IV).

    Plenty of memory + sparsity acceleration -> unstructured (quality).
    Cannot fit even the composite model -> structured (max shrink).
    Otherwise -> composite. The composite size estimate uses the
    recipe's actual ``structured_share`` (the physically removed
    fraction of the target), not a hardcoded half.
    """
    if platform.has_sparse_accel and dense_bytes <= platform.memory_bytes:
        return "unstructured"
    composite_bytes = dense_bytes * (1.0 - structured_share * p)
    if composite_bytes <= platform.memory_bytes:
        return "composite"
    return "structured"


def resolve_category(recipe: PruneRecipe, dense_bytes: int,
                     platform: Optional[Platform] = None) -> str:
    """Recipe category, or platform-driven selection when deferred."""
    if recipe.category is not None:
        return recipe.category
    plat = platform
    if plat is None and recipe.platform is not None:
        if recipe.platform not in PLATFORMS:
            raise KeyError(f"unknown platform {recipe.platform!r}; "
                           f"presets: {sorted(PLATFORMS)}")
        plat = PLATFORMS[recipe.platform]
    if plat is None:
        return "composite"
    return select_category(plat, dense_bytes, recipe.p,
                           recipe.structured_share)
