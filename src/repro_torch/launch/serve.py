"""Serving launcher: prune a random-initialised model with a recipe, then
serve it on the static engine, dense or through the block-sparse kernel.

  # the README's main path, on the GPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \
      --prune 0.5 --category composite --sparse

  # a recipe at smoke size, on the CPU (kernels run their plain versions)
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke \
      --recipe recipes/golden-smoke.json --sparse --device cpu

Runs on ``--device cuda`` (the default) and raises when CUDA is missing,
unless ``--device cpu`` is given. ``--engine continuous``, ``--artifact``
and ``--gateway`` are not ported yet and exit with an error.
"""
from __future__ import annotations

import argparse
import logging
import time

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models import transformer as T
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _load_or_prune(args, device: torch.device) -> tuple:
    """Returns (params, cfg, packed, label)."""
    if args.recipe or args.prune > 0:
        if args.recipe:
            recipe = PruneRecipe.load(args.recipe)
        else:
            recipe = PruneRecipe(
                arch=args.arch, p=args.prune, category=args.category,
                align_channels=8, block=args.sparse_block,
                calibration=CalibrationSpec(n_samples=8, batch_size=4,
                                            seq_len=args.prompt_len))
        if not args.sparse:
            # plans would be discarded — skip the pack stage entirely
            recipe = recipe.replace(stages=tuple(
                s for s in recipe.stages if s != "pack"))
        elif "pack" not in recipe.stages:
            stages = list(recipe.stages)
            at = stages.index("report") if "report" in stages else len(stages)
            recipe = recipe.replace(stages=tuple(
                stages[:at] + ["pack"] + stages[at:]))
        cfg = (get_smoke_config(recipe.arch) if args.smoke
               else get_config(recipe.arch))
        cfg = cfg.replace(scan_layers=False)
        params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
        art = MosaicPipeline(recipe).run(params, cfg)
        print(f"pruned p={recipe.p:.0%} via "
              f"{art.report.get('category') or recipe.category or 'auto'} "
              f"in {art.report.get('pipeline_seconds', 0.0):.1f}s")
        return art.params, art.cfg, (art.packed if args.sparse else None), \
            "recipe"

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = cfg.replace(scan_layers=False)
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)
    packed = None
    if args.sparse:
        # unpruned weights have no zero tiles, but the kernel path is
        # still exercised (plans at 100% density)
        from repro_torch.serve.sparse import pack_model
        packed = pack_model(params, cfg, block=args.sparse_block) or None
    return params, cfg, packed, "dense"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=list_archs(), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--recipe", default=None, metavar="JSON",
                    help="run a PruneRecipe end-to-end, then serve it")
    ap.add_argument("--engine", choices=["static", "continuous"],
                    default="static")
    ap.add_argument("--artifact", default=None, metavar="DIR",
                    help="serve a saved PrunedArtifact bundle (not ported)")
    ap.add_argument("--gateway", action="store_true",
                    help="start the HTTP front door (not ported)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--prune", type=float, default=0.0)
    ap.add_argument("--category", default="composite",
                    choices=["unstructured", "structured", "composite"])
    ap.add_argument("--sparse", action="store_true",
                    help="serve pruned MLPs through the block-sparse kernel")
    ap.add_argument("--sparse-block", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is missing) or "
                         "cpu")
    return ap


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    args = build_parser().parse_args(argv)
    for flag, on in (("--engine continuous", args.engine == "continuous"),
                     ("--artifact", args.artifact is not None),
                     ("--gateway", args.gateway)):
        if on:
            raise SystemExit(f"{flag} is not yet ported to repro_torch; "
                             f"use the static engine with --recipe/--prune")
    device = resolve_device(args.device)

    params, cfg, packed, source = _load_or_prune(args, device)
    if packed:
        from repro_torch.serve.sparse import flop_savings
        print(f"sparse fast path: {len(packed)} plans "
              f"({source}), {flop_savings(packed):.0%} projection "
              f"FLOPs skipped")

    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    serve_cfg = ServeConfig(max_seq=args.prompt_len + args.new_tokens,
                            compute_dtype=torch.float32,
                            cache_dtype=torch.float32)
    eng = Engine(params, cfg, serve_cfg, packed=packed)
    prompt = corpus.batch(0, args.batch, args.prompt_len)[:, :args.prompt_len]
    _sync(device)
    t0 = time.perf_counter()
    out = eng.generate(prompt, args.new_tokens, temperature=args.temperature)
    _sync(device)
    dt = time.perf_counter() - t0
    toks = args.batch * args.new_tokens
    print(f"generated {tuple(out.shape)} on {device} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s incl. first-call set-up)")
    print("sample:", out[0, -args.new_tokens:].tolist()[:16], "...")


if __name__ == "__main__":
    main()
