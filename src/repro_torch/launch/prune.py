"""Mosaic pruning launcher: one PruneRecipe drives RC -> planner ->
category -> pack -> report, and saves a deployment-ready PrunedArtifact.

  # declarative: the recipe JSON is the whole configuration
  PYTHONPATH=src python -m repro_torch.launch.prune --smoke \
      --recipe recipes/golden-smoke.json --out results/pruned --device cpu

  # or assemble the recipe from flags (same pipeline)
  PYTHONPATH=src python -m repro_torch.launch.prune --smoke \
      --p 0.6 --category composite --block 16 --out results/pruned

  # or target a deployment platform: a bare --platform loads the
  # checked-in preset recipe (recipes/<platform>.json)
  PYTHONPATH=src python -m repro_torch.launch.prune --smoke \
      --platform edge --out results/pruned_edge

The saved directory is everything ``launch/serve.py --artifact`` needs,
in the JAX package's layout, so either package serves it. Runs on
``--device cuda`` (the default) and raises when CUDA is missing, unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import json
import logging
import pathlib

import torch

from repro_torch.common.device import resolve_device
from repro_torch.common.tree import param_bytes, param_count
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.prune_controller import PLATFORMS
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.models import transformer as T


def recipe_from_args(args: argparse.Namespace) -> PruneRecipe:
    if args.recipe:
        recipe = PruneRecipe.load(args.recipe)
        if args.p is not None:
            recipe = recipe.replace(p=args.p)
        return recipe
    if args.platform:
        # a bare --platform resolves the checked-in preset recipe for
        # that deployment target; --p still overrides its target
        preset = pathlib.Path(__file__).parents[3] / "recipes" \
            / f"{args.platform}.json"
        if preset.is_file():
            recipe = PruneRecipe.load(preset)
            if args.p is not None:
                recipe = recipe.replace(p=args.p)
            return recipe
    if args.p is None:
        raise SystemExit("either --recipe, --platform (with a preset in "
                         "recipes/), or --p is required")
    return PruneRecipe(
        arch=args.arch, p=args.p, category=args.category,
        granularity=args.granularity, selector=args.selector,
        platform=args.platform, align_channels=args.align_channels,
        block=args.block,
        calibration=CalibrationSpec(n_samples=args.calib_samples,
                                    batch_size=8, seq_len=64))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", default=None, metavar="JSON",
                    help="PruneRecipe JSON file (overrides the flags below)")
    ap.add_argument("--arch", choices=list_archs(), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--p", type=float, default=None)
    ap.add_argument("--category", default=None,
                    choices=[None, "unstructured", "structured", "composite"])
    ap.add_argument("--platform", default=None, choices=sorted(PLATFORMS))
    ap.add_argument("--granularity", default="projection",
                    choices=["global", "layer", "projection"])
    ap.add_argument("--selector", default="wanda",
                    choices=["magnitude", "wanda", "wanda_block", "sparsegpt"])
    ap.add_argument("--align-channels", type=int, default=8)
    ap.add_argument("--block", type=int, default=128,
                    help="block-sparse tile: pack-stage plan size AND the "
                         "wanda_block mask tile — must divide the model's "
                         "projection dims (use 16 for smoke configs)")
    ap.add_argument("--calib-samples", type=int, default=32)
    ap.add_argument("--out", default=None,
                    help="directory to save the PrunedArtifact bundle")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is missing) or "
                         "cpu")
    return ap


def main(argv=None) -> None:
    # surface INFO logs (e.g. pack_model's skipped-projection summary)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    recipe = recipe_from_args(args)
    cfg = (get_smoke_config(recipe.arch) if args.smoke
           else get_config(recipe.arch))
    cfg = cfg.replace(scan_layers=False)
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)

    print(f"pipeline: {list(recipe.stages)} over {cfg.name} "
          f"({param_count(params) / 1e6:.1f}M params) on {device}")
    artifact = MosaicPipeline(recipe).run(params, cfg)
    rep = artifact.report              # {} when 'report' not in stages
    if rep.get("profile_seconds") is not None:
        print(f"RC: {rep['profile_seconds']:.1f}s over "
              f"{rep['calibration_tokens']} tokens")
    print(f"PC: category={rep.get('category')} "
          f"granularity={recipe.granularity} "
          f"in {rep.get('prune_seconds', 0.0):.1f}s")
    if rep.get("pack"):
        pk = rep["pack"]
        print(f"pack: {pk['n_packed']} plans (block {pk['block']}), "
              f"{pk['n_skipped']} skipped ({pk['skipped_params']} params), "
              f"{pk['flop_savings']:.0%} FLOPs skippable")
    print(f"params {param_count(params)} -> {param_count(artifact.params)}  "
          f"bytes {param_bytes(params)} -> {param_bytes(artifact.params)}")
    print(f"pipeline total {rep.get('pipeline_seconds', 0.0):.1f}s")
    if args.out:
        artifact.save(args.out)
        print(f"saved PrunedArtifact to {args.out}")
        print(json.dumps({k: rep.get(k) for k in
                          ("arch", "category", "prune_seconds",
                           "pipeline_seconds")}))


if __name__ == "__main__":
    main()
