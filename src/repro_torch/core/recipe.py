"""Declarative pruning recipe: one JSON document drives the whole
Mosaic pipeline (Fig. 6) — RC profiling, projection planning, category
execution, block-plan packing, and reporting.

A :class:`PruneRecipe` is a frozen dataclass with an exact JSON
round-trip (``to_json`` / ``from_json``); the same file works for
``launch/prune.py --recipe`` and ``launch/serve.py --recipe``, and is
embedded verbatim into every saved :class:`~repro_torch.core.artifact.
PrunedArtifact` as provenance.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional

GRANULARITIES = ("global", "layer", "projection")
DEFAULT_STAGES = ("rank", "plan", "prune", "pack", "report")
QUANT_MODES = ("none", "int8")


@dataclasses.dataclass(frozen=True)
class CalibrationSpec:
    """How to draw the RC calibration set (paper: 128 x 2048 tokens)."""
    n_samples: int = 32
    batch_size: int = 8
    seq_len: int = 64
    seed: int = 0

    def __post_init__(self):
        if self.n_samples <= 0 or self.batch_size <= 0 or self.seq_len <= 0:
            raise ValueError(f"calibration sizes must be positive: {self}")


@dataclasses.dataclass(frozen=True)
class PruneRecipe:
    """Everything the Mosaic pipeline needs, declaratively.

    ``category=None`` defers to platform-based selection (PC step 9);
    ``platform`` names a preset in ``prune_controller.PLATFORMS``.
    ``block`` is the block-sparse kernel tile the ``pack`` stage plans
    for; ``group_experts`` marks MoE expert plan stacks for the grouped
    (one-launch-for-all-experts) kernel instead of the per-expert launch
    loop; ``ragged_moe`` additionally marks them for the ragged
    (routed-tokens-only) dispatch at decode batch sizes. ``quant``
    ("none" | "int8") makes the pack stage compact each plan's *kept*
    tiles into int8 storage with per-tile pow2 scales — the sparse ×
    quantized serving path. ``stages`` is the ordered subset of the
    stage registry to run.
    """
    arch: str
    p: float
    category: Optional[str] = None
    granularity: str = "projection"
    selector: str = "wanda"
    spread: float = 0.25
    within_spread: float = 0.1
    structured_share: float = 0.5
    align_heads: int = 1
    align_channels: int = 1
    per_output: bool = True
    platform: Optional[str] = None
    block: int = 128
    group_experts: bool = True
    ragged_moe: bool = False
    quant: str = "none"
    calibration: CalibrationSpec = CalibrationSpec()
    stages: tuple = DEFAULT_STAGES

    def __post_init__(self):
        if not 0.0 <= self.p < 1.0:
            raise ValueError(f"pruning target p={self.p} outside [0, 1)")
        if self.granularity not in GRANULARITIES:
            raise ValueError(f"unknown granularity {self.granularity!r}; "
                             f"choices: {GRANULARITIES}")
        if self.quant not in QUANT_MODES:
            raise ValueError(f"unknown quant {self.quant!r}; "
                             f"choices: {QUANT_MODES}")
        if not 0.0 <= self.structured_share <= 1.0:
            raise ValueError(
                f"structured_share={self.structured_share} outside [0, 1]")
        if self.block <= 0:
            raise ValueError(f"block={self.block} must be positive")
        # selector/category names are validated against the plug-in
        # registries at execution time (registration is import-driven)
        object.__setattr__(self, "stages", tuple(self.stages))

    # ------------------------------------------------------------- codec

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["stages"] = list(self.stages)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PruneRecipe":
        d = dict(d)
        unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown recipe fields: {sorted(unknown)}")
        calib = d.get("calibration")
        if isinstance(calib, dict):
            d["calibration"] = CalibrationSpec(**calib)
        if "stages" in d:
            d["stages"] = tuple(d["stages"])
        return cls(**d)

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @classmethod
    def from_json(cls, text: str) -> "PruneRecipe":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str) -> "PruneRecipe":
        with open(path) as f:
            return cls.from_json(f.read())

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json() + "\n")

    def replace(self, **kw) -> "PruneRecipe":
        return dataclasses.replace(self, **kw)
