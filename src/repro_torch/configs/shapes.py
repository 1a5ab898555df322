"""The assigned input-shape set (per-arch cells of the dry-run matrix)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq: int
    batch: int
    subquadratic_only: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1,
                           subquadratic_only=True),
}


def applicable(shape: ShapeSpec, cfg) -> bool:
    """long_500k only for sub-quadratic (SSM / hybrid) archs; decoder-only
    archs run all decode shapes."""
    if shape.subquadratic_only and not cfg.subquadratic:
        return False
    return True
