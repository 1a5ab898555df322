"""Recipe sweeps: profile once, prune many (the paper's E5 reuse win).

The Ranking Controller profiles the model ONCE; the resulting
:class:`~repro_torch.core.rank_controller.RankArtifact` is reused by
every pruning level and category (Fig. 5 / Algorithm 1 — the source of
Mosaic's 7.19x model-production speedup). :func:`run_sweep` turns that
property into a subsystem: one base
:class:`~repro_torch.core.recipe.PruneRecipe` plus a :class:`GridSpec`
fan a single profile across a p-level x category x selector x precision
grid, save each point's
:class:`~repro_torch.core.artifact.PrunedArtifact`, evaluate each
point's quality (ppl / acc via the ``evaluate`` stage), and emit a
Pareto table (CSV + markdown) ranking the points by quality-per-byte.

Grid-spec JSON (any subset of axes; omitted axes inherit the base
recipe's value)::

    {"p": [0.3, 0.5, 0.7], "category": ["composite", "unstructured"]}

Output layout (``out_dir``)::

    profile/          # the single RankArtifact (reused, reloadable)
    points/<label>/   # one PrunedArtifact bundle per grid point
    pareto.csv        # one row per point: quality + size + time
    pareto.md         # the same table, human-readable

Re-running a sweep over the same ``out_dir`` resumes: points whose
bundle already exists are skipped (their Pareto row is rebuilt from the
saved ``report.json``) — pass ``resume=False`` / ``--fresh`` to force.
The layout and every file in it are the JAX package's, so either package
resumes the other's sweep. The sweep runs on the params' device.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Iterable, Optional, Union

from repro_torch.core.artifact import RECIPE_FILE, REPORT_FILE, PrunedArtifact
from repro_torch.core.evaluate import default_eval_batches
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import (RankArtifact, ensure_hessians,
                                        profile_model)
from repro_torch.core.recipe import PruneRecipe
from repro_torch.models.specs import ModelConfig

GRID_AXES = ("p", "category", "selector", "granularity", "quant")

CSV_COLUMNS = ("label", "arch", "p", "category", "selector", "granularity",
               "quant", "ppl", "acc", "bytes_after", "params_after",
               "prune_seconds", "point_seconds", "flop_savings",
               "expert_plans", "quality_per_byte", "pareto")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """The sweep grid: values per recipe axis; empty axis = keep base.
    The ``quant`` axis sweeps precision ("none" / "int8") against the
    same profile, so Pareto rows chart quality-per-byte across
    p × precision."""
    p: tuple = ()
    category: tuple = ()
    selector: tuple = ()
    granularity: tuple = ()
    quant: tuple = ()

    def __post_init__(self):
        for name in GRID_AXES:
            object.__setattr__(self, name, tuple(getattr(self, name)))

    def points(self, base: PruneRecipe) -> list:
        """Cartesian product of the axes, materialised as recipes."""
        axes = [getattr(self, name) or (getattr(base, name),)
                for name in GRID_AXES]
        return [base.replace(**dict(zip(GRID_AXES, combo)))
                for combo in itertools.product(*axes)]

    def n_points(self) -> int:
        n = 1
        for name in GRID_AXES:
            n *= max(len(getattr(self, name)), 1)
        return n

    # ------------------------------------------------------------- codec

    def to_dict(self) -> dict:
        return {name: list(getattr(self, name)) for name in GRID_AXES
                if getattr(self, name)}

    @classmethod
    def from_dict(cls, d: dict) -> "GridSpec":
        unknown = set(d) - set(GRID_AXES)
        if unknown:
            raise ValueError(f"unknown grid axes: {sorted(unknown)}; "
                             f"choices: {GRID_AXES}")
        for k, v in d.items():
            if not isinstance(v, (list, tuple)):
                raise ValueError(f"grid axis {k!r} must be a list of "
                                 f"values, got {v!r}")
        return cls(**{k: tuple(v) for k, v in d.items()})

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "GridSpec":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "GridSpec":
        with open(path) as f:
            return cls.from_json(f.read())


def point_label(recipe: PruneRecipe) -> str:
    """Filesystem-safe grid-point name, e.g. ``p0.5-composite-wanda``."""
    parts = [f"p{recipe.p:g}", recipe.category or "auto", recipe.selector]
    if recipe.granularity != "projection":
        parts.append(recipe.granularity)
    if recipe.quant != "none":
        parts.append(recipe.quant)
    return "-".join(parts)


@dataclasses.dataclass
class SweepResult:
    rows: list                       # one report dict per grid point
    rank_artifact: Optional[RankArtifact]  # the single reused profile
    # (None when every point resumed and no profile was supplied)
    profiled: bool                   # False when the profile was supplied
    out_dir: Optional[str] = None
    csv_path: Optional[str] = None
    md_path: Optional[str] = None


def _resume_report(artifact_dir: Optional[str],
                   point: PruneRecipe) -> Optional[dict]:
    """The saved report of a resumable grid point, or None when the
    point must (re-)execute. The label only encodes p / category /
    selector / granularity, so the bundle's own ``recipe.json`` must
    equal the current point recipe — editing any other base-recipe
    field (block, spread, calibration, ...) invalidates the bundle
    instead of silently serving stale results."""
    if not artifact_dir or not PrunedArtifact.is_artifact(artifact_dir):
        return None
    report_path = os.path.join(artifact_dir, REPORT_FILE)
    if not os.path.exists(report_path):
        return None
    try:
        with open(os.path.join(artifact_dir, RECIPE_FILE)) as f:
            saved = PruneRecipe.from_dict(json.load(f))
        if saved != point:
            return None
        with open(report_path) as f:
            return json.load(f)
    except (OSError, ValueError, TypeError, KeyError):
        return None       # unreadable/truncated/foreign bundle: re-run


def _point_stages(stages: Iterable) -> tuple:
    """Sweep-point stage list: never re-rank; always evaluate + report."""
    ordered = [s for s in stages if s != "rank"]
    if "report" not in ordered:
        ordered.append("report")
    if "evaluate" not in ordered:
        ordered.insert(ordered.index("report"), "evaluate")
    return tuple(ordered)


def run_sweep(base: PruneRecipe,
              grid: Union[GridSpec, Iterable],
              params, cfg: ModelConfig, *,
              out_dir: Optional[str] = None,
              calibration: Optional[list] = None,
              rank_artifact: Optional[RankArtifact] = None,
              eval_batches: Optional[dict] = None,
              resume: bool = True,
              progress: Optional[Callable] = None) -> SweepResult:
    """Profile once, prune many, evaluate every point, rank by Pareto.

    ``grid`` is a :class:`GridSpec` (expanded against ``base``) or an
    explicit iterable of recipes. ``rank_artifact`` skips profiling
    entirely (e.g. a profile loaded from disk); otherwise
    ``profile_model`` runs exactly once for the whole sweep, with
    Hessians only when some point's selector needs them — and a supplied
    Hessian-free profile gains them lazily via :func:`ensure_hessians`.

    ``resume`` (default on): grid points whose ``points/<label>/``
    bundle already exists under ``out_dir`` are not re-pruned — their
    Pareto row is rebuilt from the saved ``report.json``, so an
    interrupted sweep re-run pays only for the missing points. Pass
    ``resume=False`` to force every point to re-execute.
    """
    say = progress or (lambda *_: None)
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    points = grid.points(base) if isinstance(grid, GridSpec) else list(grid)
    if not points:
        raise ValueError("empty sweep grid")
    want_hessians = any(r.selector == "sparsegpt" for r in points)

    def _calibration():
        if calibration is not None:
            return calibration
        from repro_torch.data.pipeline import SyntheticCorpus
        c = base.calibration
        corpus = SyntheticCorpus(cfg.vocab, seed=c.seed)
        return corpus.calibration_batches(c.n_samples, c.batch_size,
                                          c.seq_len)

    profiled = False

    profile_ready = False

    def ensure_profile() -> RankArtifact:
        """Profile (or attach Hessians) on first *executed* point only —
        a fully-resumed sweep re-run never pays the calibration cost."""
        nonlocal rank_artifact, profiled, profile_ready
        if profile_ready:
            return rank_artifact
        if rank_artifact is None:
            say(f"profiling once for {len(points)} points "
                f"(hessians={want_hessians})")
            rank_artifact = profile_model(params, cfg, _calibration(),
                                          want_hessians=want_hessians)
            profiled = True
        elif want_hessians and rank_artifact.hessians is None:
            say("attaching hessians to the supplied profile (lazy)")
            rank_artifact = ensure_hessians(rank_artifact, params, cfg,
                                            _calibration())
        if out_dir:
            rank_artifact.save(os.path.join(out_dir, "profile"))
        profile_ready = True
        return rank_artifact

    if eval_batches is None:
        eval_batches = default_eval_batches(cfg, base)

    rows = []
    labels: dict = {}
    n_resumed = 0
    for recipe in points:
        point = recipe.replace(stages=_point_stages(recipe.stages))
        label = point_label(point)
        if label in labels:                      # duplicate grid points
            labels[label] += 1
            label = f"{label}-{labels[label]}"
        else:
            labels[label] = 0
        artifact_dir = (os.path.join(out_dir, "points", label)
                        if out_dir else None)
        rep = _resume_report(artifact_dir, point) if resume else None
        if rep is not None:
            point_seconds = 0.0
            n_resumed += 1
        else:
            t0 = time.perf_counter()
            artifact = MosaicPipeline(point).run(
                params, cfg, rank_artifact=ensure_profile(),
                eval_batches=eval_batches)
            point_seconds = time.perf_counter() - t0
            if artifact_dir:
                artifact.save(artifact_dir)
            rep = artifact.report
        pack = rep.get("pack") or {}
        rows.append({
            "label": label,
            "arch": point.arch,
            "p": point.p,
            "category": rep.get("category"),
            "selector": point.selector,
            "granularity": point.granularity,
            "quant": rep.get("quant", point.quant),
            "ppl": rep.get("ppl"),
            "acc": rep.get("acc"),
            "bytes_after": rep.get("bytes_after"),
            "params_after": rep.get("params_after"),
            "prune_seconds": rep.get("prune_seconds"),
            "point_seconds": point_seconds,
            "flop_savings": pack.get("flop_savings"),
            "expert_plans": pack.get("n_expert_packed"),
            "artifact_dir": artifact_dir,
        })
        if progress:
            r = rows[-1]
            progress(f"{label}: ppl={_fmt(r, 'ppl')} acc={_fmt(r, 'acc')} "
                     f"bytes={r['bytes_after']} in {point_seconds:.1f}s")
    if n_resumed:
        say(f"resume: skipped {n_resumed}/{len(points)} grid points with "
            f"existing bundles under {os.path.join(out_dir, 'points')}")

    annotate_pareto(rows)
    rows.sort(key=lambda r: -(r["quality_per_byte"] or 0.0))
    result = SweepResult(rows=rows, rank_artifact=rank_artifact,
                         profiled=profiled, out_dir=out_dir)
    if out_dir:
        result.csv_path = os.path.join(out_dir, "pareto.csv")
        result.md_path = os.path.join(out_dir, "pareto.md")
        with open(result.csv_path, "w") as f:
            f.write(pareto_csv(rows))
        with open(result.md_path, "w") as f:
            f.write(pareto_markdown(rows))
    return result


# -------------------------------------------------------------- pareto

def annotate_pareto(rows: list) -> list:
    """Add ``quality_per_byte`` (accuracy points per MiB kept — higher
    is better) and the ``pareto`` flag (no other point has both lower
    perplexity and fewer bytes)."""
    for r in rows:
        if r.get("acc") is not None and r.get("bytes_after"):
            r["quality_per_byte"] = r["acc"] / (r["bytes_after"] / 2 ** 20)
        else:
            r["quality_per_byte"] = None
    scored = [r for r in rows
              if r.get("ppl") is not None and r.get("bytes_after")]
    for r in rows:
        if r.get("ppl") is None or not r.get("bytes_after"):
            r["pareto"] = False
            continue
        r["pareto"] = not any(
            o is not r
            and o["ppl"] <= r["ppl"] and o["bytes_after"] <= r["bytes_after"]
            and (o["ppl"] < r["ppl"] or o["bytes_after"] < r["bytes_after"])
            for o in scored)
    return rows


def _fmt(row: dict, col: str) -> str:
    v = row.get(col)
    if v is None:
        return ""
    if col in ("ppl", "acc"):
        return f"{v:.4f}"
    if col in ("prune_seconds", "point_seconds"):
        return f"{v:.4f}"
    if col in ("flop_savings", "quality_per_byte"):
        return f"{v:.6g}"
    if col == "pareto":
        return "1" if v else "0"
    return str(v)


def pareto_csv(rows: list) -> str:
    lines = [",".join(CSV_COLUMNS)]
    lines += [",".join(_fmt(r, c) for c in CSV_COLUMNS) for r in rows]
    return "\n".join(lines) + "\n"


def pareto_markdown(rows: list) -> str:
    head = "| " + " | ".join(CSV_COLUMNS) + " |"
    sep = "|" + "|".join("---" for _ in CSV_COLUMNS) + "|"
    body = ["| " + " | ".join(_fmt(r, c) or "-" for c in CSV_COLUMNS) + " |"
            for r in rows]
    return "\n".join([head, sep] + body) + "\n"
