"""Composite projection pruning (the paper's headline contribution).

Unstructured pruning at the POD targets keeps quality; structured pruning
*of the weight groups the masks have already hollowed out* shrinks the
model. Paper order (PC step 9): mask first, then remove the
lowest-magnitude heads/channels — the mask decides which groups die.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import structured as S
from repro_torch.core import unstructured as U
from repro_torch.core.registry import register_category
from repro_torch.models.specs import ModelConfig


def prune_composite(params, cfg: ModelConfig, targets: dict,
                    selector: str = "wanda",
                    anorms: Optional[dict] = None,
                    hessians: Optional[dict] = None,
                    structured_share: float = 0.5,
                    align_heads: int = 1, align_channels: int = 1,
                    per_output: bool = True,
                    block: int = 16):
    """Returns (new_params, new_cfg, info).

    targets: per-projection POD targets (mean == p). structured_share: the
    fraction of each target realised as physical group removal; the mask
    realises the full target first, so groups removed second are mostly
    zeros already and total removed parameters land near p.
    """
    params, masks = U.prune_unstructured(
        params, cfg, targets, selector=selector, anorms=anorms,
        hessians=hessians, per_output=per_output, block=block)
    fractions = S.structured_fractions(targets, cfg, share=structured_share)
    new_params, new_cfg = S.prune_structured(
        params, cfg, fractions, align_heads=align_heads,
        align_channels=align_channels)
    info = {
        "unstructured_sparsity": U.achieved_sparsity(masks),
        "structured_fractions": fractions,
    }
    return new_params, new_cfg, info


@register_category("composite")
def _category_composite(params, cfg, targets, artifact, recipe):
    """The paper's headline mode: mask at full target, then physically
    remove the hollowed-out groups at ``structured_share``."""
    return prune_composite(
        params, cfg, targets, selector=recipe.selector,
        anorms=artifact.anorms, hessians=artifact.hessians,
        structured_share=recipe.structured_share,
        align_heads=recipe.align_heads,
        align_channels=recipe.align_channels,
        per_output=recipe.per_output, block=recipe.block)
