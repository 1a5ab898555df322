"""Recipe-sweep launcher: one RC profile fanned across a recipe grid.

The paper's E5 overhead win: ``profile_model`` runs at most once per
sweep (zero times when ``--rank-artifact`` points at a saved profile),
every grid point reuses the same
:class:`~repro_torch.core.rank_controller.RankArtifact`, and each
point's quality/size trade-off lands in one Pareto table.

  # 6-point grid (3 p-levels x 2 categories) from the golden recipe
  PYTHONPATH=src python -m repro_torch.launch.sweep --smoke \
      --recipe recipes/golden-smoke.json \
      --p 0.3,0.5,0.7 --category composite,unstructured \
      --out results/sweep --device cpu

  # grid from JSON; cache the profile for later sweeps of the same model
  PYTHONPATH=src python -m repro_torch.launch.sweep --smoke \
      --recipe recipes/golden-smoke.json --grid recipes/sweep-grid.json \
      --rank-artifact results/profile --out results/sweep

``--rank-artifact DIR`` loads the profile when DIR holds one, and saves
the freshly computed profile there otherwise — the second sweep never
re-profiles. Outputs under ``--out``: ``points/<label>/`` PrunedArtifact
bundles, ``profile/`` the reusable RankArtifact, ``pareto.csv`` +
``pareto.md`` with one row per point (ppl, acc, bytes_after,
prune_seconds, quality_per_byte, pareto flag). The files are the JAX
package's, so either package resumes the other's sweep. Runs on
``--device cuda`` (the default) and raises when CUDA is missing, unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.common.device import resolve_device
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.core.rank_controller import RankArtifact
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.core.sweep import GridSpec, pareto_markdown, run_sweep
from repro_torch.models import transformer as T


def _split(text, cast):
    return tuple(cast(x) for x in text.split(",") if x)


def grid_from_args(args: argparse.Namespace) -> GridSpec:
    if args.grid:
        return GridSpec.load(args.grid)
    return GridSpec(
        p=_split(args.p or "", float),
        category=_split(args.category or "", str),
        selector=_split(args.selector or "", str),
        granularity=_split(args.granularity or "", str))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--recipe", default=None, metavar="JSON",
                    help="base PruneRecipe JSON (axes not in the grid "
                         "keep its values)")
    ap.add_argument("--arch", choices=list_archs(), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--grid", default=None, metavar="JSON",
                    help="GridSpec JSON file (overrides the axis flags)")
    ap.add_argument("--p", default=None,
                    help="comma-separated pruning levels, e.g. 0.3,0.5,0.7")
    ap.add_argument("--category", default=None,
                    help="comma-separated categories, e.g. "
                         "composite,unstructured")
    ap.add_argument("--selector", default=None,
                    help="comma-separated selectors, e.g. wanda,sparsegpt")
    ap.add_argument("--granularity", default=None,
                    help="comma-separated granularities")
    ap.add_argument("--rank-artifact", default=None, metavar="DIR",
                    help="load the RC profile from DIR if present, else "
                         "profile once and save it there")
    ap.add_argument("--calib-samples", type=int, default=32)
    ap.add_argument("--out", default="results/sweep",
                    help="sweep output directory (artifacts + Pareto)")
    ap.add_argument("--fresh", action="store_true",
                    help="re-execute every grid point even when its "
                         "points/<label>/ bundle already exists (default: "
                         "resume — existing bundles are skipped)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises when CUDA is missing) or "
                         "cpu")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    if args.recipe:
        base = PruneRecipe.load(args.recipe)
    else:
        base = PruneRecipe(
            arch=args.arch, p=0.5, category="composite",
            calibration=CalibrationSpec(n_samples=args.calib_samples,
                                        batch_size=8, seq_len=64))
    grid = grid_from_args(args)

    cfg = (get_smoke_config(base.arch) if args.smoke
           else get_config(base.arch))
    cfg = cfg.replace(scan_layers=False)
    params = T.init_model(torch.Generator(device=device).manual_seed(0), cfg)

    rank_artifact = None
    if args.rank_artifact and RankArtifact.is_artifact(args.rank_artifact):
        rank_artifact = RankArtifact.load(args.rank_artifact, device)
        print(f"profile: loaded from {args.rank_artifact} "
              f"({rank_artifact.n_tokens} calibration tokens)")

    print(f"sweep: {grid.n_points()} points over {cfg.name} on {device}")
    res = run_sweep(base, grid, params, cfg, out_dir=args.out,
                    rank_artifact=rank_artifact, resume=not args.fresh,
                    progress=print)

    if res.profiled:
        print(f"profile: computed once "
              f"({res.rank_artifact.profile_seconds:.1f}s), reused for "
              f"all {len(res.rows)} points")
    # re-cache when freshly profiled or when the sweep attached Hessians
    # to a Hessian-free cached profile: the next sweep pays neither the
    # profile nor the Hessian pass
    gained_hessians = (rank_artifact is not None
                       and rank_artifact.hessians is None
                       and res.rank_artifact.hessians is not None)
    if args.rank_artifact and (res.profiled or gained_hessians):
        res.rank_artifact.save(args.rank_artifact)
        print(f"profile: cached to {args.rank_artifact}")
    print()
    print(pareto_markdown(res.rows))
    print(f"pareto csv: {res.csv_path}")


if __name__ == "__main__":
    main()
