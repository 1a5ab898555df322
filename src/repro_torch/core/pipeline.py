"""MosaicPipeline: staged execution of the paper's Fig. 6 flow — RC
profiling -> projection planning -> category execution -> post-pruning
block packing -> quality evaluation -> report.

Stages are named entries in ``repro_torch.core.registry.STAGES``
operating on a shared :class:`PipelineContext`; a
:class:`~repro_torch.core.recipe.PruneRecipe` picks the ordered subset to
run.

    recipe = PruneRecipe.load("recipes/golden-smoke.json")
    artifact = MosaicPipeline(recipe).run(params, cfg)
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.common.tree import param_bytes, param_count, tree_device
from repro_torch.core import evaluate as _EV   # noqa: F401 (registers stage)
from repro_torch.core import planner as PL
from repro_torch.core import prune_controller as PC
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.rank_controller import RankArtifact, profile_model
from repro_torch.core.recipe import PruneRecipe
from repro_torch.core.registry import CATEGORIES, STAGES, register_stage
from repro_torch.models.specs import ModelConfig


@dataclasses.dataclass
class PipelineContext:
    """Mutable state threaded through the stages."""
    recipe: PruneRecipe
    params: Any
    cfg: ModelConfig
    calibration: Optional[list] = None
    platform: Optional[PC.Platform] = None
    rank_artifact: Optional[RankArtifact] = None
    targets: Optional[dict] = None
    category: Optional[str] = None
    info: dict = dataclasses.field(default_factory=dict)
    packed: dict = dataclasses.field(default_factory=dict)
    pack_report: Optional[dict] = None
    dense_params: int = 0
    dense_bytes: int = 0
    timings: dict = dataclasses.field(default_factory=dict)
    report: dict = dataclasses.field(default_factory=dict)
    eval_batches: Optional[dict] = None   # held-out set for 'evaluate'
    quality: Optional[dict] = None        # {'ppl': ..., 'acc': ...}


# ------------------------------------------------------------- stages

@register_stage("rank")
def stage_rank(ctx: PipelineContext) -> None:
    """RC profiling; reuses a caller-provided RankArtifact if present
    (one profile serves every p and category — the paper's E5 win)."""
    if ctx.rank_artifact is not None:
        return
    calib = ctx.calibration
    if calib is None:
        from repro_torch.data.pipeline import SyntheticCorpus
        c = ctx.recipe.calibration
        corpus = SyntheticCorpus(ctx.cfg.vocab, seed=c.seed)
        calib = corpus.calibration_batches(c.n_samples, c.batch_size,
                                           c.seq_len)
    ctx.rank_artifact = profile_model(
        ctx.params, ctx.cfg, calib,
        want_hessians=ctx.recipe.selector == "sparsegpt")


@register_stage("plan")
def stage_plan(ctx: PipelineContext) -> None:
    """Projection Planner: global rank + p -> per-projection targets."""
    if ctx.rank_artifact is None:
        raise RuntimeError("'plan' needs a rank artifact: run the 'rank' "
                           "stage first or pass rank_artifact= to run()")
    ctx.targets = PL.plan_from_recipe(ctx.rank_artifact.rank, ctx.recipe,
                                      weights=ctx.rank_artifact.weights)


@register_stage("prune")
def stage_prune(ctx: PipelineContext) -> None:
    """Category execution via the plug-in registry (PC steps 9-10)."""
    if ctx.targets is None:
        raise RuntimeError("'prune' needs targets: run the 'plan' stage")
    cat = PC.resolve_category(ctx.recipe, ctx.dense_bytes, ctx.platform)
    fn = CATEGORIES.get(cat)
    ctx.params, ctx.cfg, info = fn(ctx.params, ctx.cfg, ctx.targets,
                                   ctx.rank_artifact, ctx.recipe)
    ctx.category = cat
    ctx.info.update(info)


@register_stage("pack")
def stage_pack(ctx: PipelineContext) -> None:
    """Post-Pruning Optimizer: block plans for the serving kernels — one
    per tileable dense projection, a per-expert plan stack per MoE
    expert weight (the report's ``skipped`` list carries ``reason:
    "non-tileable"``). ``recipe.group_experts`` marks the expert stacks
    for the grouped one-launch kernel (else the per-expert launch loop),
    ``recipe.ragged_moe`` for the ragged dispatch at decode sizes; the
    flags ride inside each plan through the bundle.

    ``recipe.quant="int8"`` also packs each plan's kept tiles as int8
    with pow2 scales and replaces the quantized projections' params with
    their fake-quant round trip, so the dense forward, the
    ``quant="none"`` path and the int8 kernels all see the same
    weights."""
    from repro_torch.serve.sparse import (apply_fake_quant,
                                          pack_model_with_report)
    ctx.packed, ctx.pack_report = pack_model_with_report(
        ctx.params, ctx.cfg, block=ctx.recipe.block,
        group_experts=ctx.recipe.group_experts,
        ragged_moe=ctx.recipe.ragged_moe, quant=ctx.recipe.quant)
    if ctx.recipe.quant == "int8":
        ctx.params = apply_fake_quant(ctx.params, ctx.cfg, ctx.packed)


@register_stage("report")
def stage_report(ctx: PipelineContext) -> None:
    """Provenance + timing summary. With an int8 pack, ``bytes_after`` is
    real storage: each quantized projection's dense bytes are swapped
    for its int8 tile + scale + plan bytes."""
    r = ctx.recipe
    ra = ctx.rank_artifact
    bytes_after = param_bytes(ctx.params)
    qb = (ctx.pack_report or {}).get("quant_bytes")
    if qb:
        bytes_after += qb["total_bytes"] - qb["dense_bytes"]
    ctx.report.update({
        "arch": r.arch,
        "p": r.p,
        "category": ctx.category,
        "granularity": r.granularity,
        "selector": r.selector,
        "quant": r.quant,
        "params_before": ctx.dense_params,
        "bytes_before": ctx.dense_bytes,
        "params_after": param_count(ctx.params),
        "bytes_after": bytes_after,
        "profile_seconds": ra.profile_seconds if ra else None,
        "calibration_tokens": ra.n_tokens if ra else None,
        "prune_seconds": (ctx.timings.get("plan", 0.0)
                          + ctx.timings.get("prune", 0.0)),
        "pack": ctx.pack_report,
        "info": _jsonable(ctx.info),
        "stage_seconds": {k: round(v, 6) for k, v in ctx.timings.items()},
        "pipeline_seconds": round(sum(ctx.timings.values()), 6),
        "recipe": r.to_dict(),
    })
    if ctx.quality:                       # 'evaluate' ran before 'report'
        ctx.report.update(ctx.quality)


def _jsonable(obj):
    """Best-effort JSON projection (tuple keys -> 'a:b' strings)."""
    if isinstance(obj, dict):
        return {(":".join(str(p) for p in k) if isinstance(k, tuple)
                 else str(k)): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    return obj


# ------------------------------------------------------------ pipeline

class MosaicPipeline:
    """Executes a :class:`PruneRecipe`'s stages in order."""

    def __init__(self, recipe: PruneRecipe,
                 stages: Optional[tuple] = None):
        self.recipe = recipe
        self.stage_names = tuple(stages if stages is not None
                                 else recipe.stages)
        for name in self.stage_names:      # fail fast on unknown stages
            STAGES.get(name)

    def run(self, params, cfg: ModelConfig, *,
            calibration: Optional[list] = None,
            rank_artifact: Optional[RankArtifact] = None,
            platform: Optional[PC.Platform] = None,
            eval_batches: Optional[dict] = None) -> PrunedArtifact:
        """Stage timings synchronise the params' device first, so each
        stage's seconds hold its own device work."""
        cfg = cfg if not cfg.scan_layers else cfg.unrolled()
        device = tree_device(params)
        ctx = PipelineContext(
            recipe=self.recipe, params=params, cfg=cfg,
            calibration=calibration, rank_artifact=rank_artifact,
            platform=platform, eval_batches=eval_batches,
            dense_params=param_count(params),
            dense_bytes=param_bytes(params))
        for name in self.stage_names:
            _sync(device)
            t0 = time.perf_counter()
            STAGES.get(name)(ctx)
            _sync(device)
            ctx.timings[name] = time.perf_counter() - t0
        return PrunedArtifact(params=ctx.params, cfg=ctx.cfg,
                              recipe=self.recipe, targets=ctx.targets or {},
                              packed=ctx.packed, report=ctx.report,
                              info=ctx.info)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
