"""Mosaic Parameter Ranking Controller (Fig. 5 / Algorithm 1).

Profiles the LLM once over a calibration set and emits the reusable
global rank R_LLM: one profile serves every pruning level p and every
pruning category, and, through :meth:`RankArtifact.save` /
:meth:`RankArtifact.load`, every later process. The files are the JAX
package's (``profile.npz`` + ``profile.json``).
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Iterable, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager, from_numpy
from repro_torch.common.device import resolve_device
from repro_torch.common.tree import tree_device, tree_get
from repro_torch.core import calibrate as C
from repro_torch.core import pod
from repro_torch.core.registry import projections
from repro_torch.models.specs import ModelConfig

PROFILE_FILE = "profile.json"
PROFILE_ARRAYS = "profile.npz"


@dataclasses.dataclass
class RankArtifact:
    """Output of the RC: everything the PC needs."""
    rank: dict                  # {(layer, name): normalised rank}
    anorms: dict                # {(layer, tap): ||A||_2 per channel}
    weights: dict               # {(layer, name): param count}
    n_tokens: int
    profile_seconds: float
    hessians: Optional[dict] = None     # only when sparsegpt requested

    # ----------------------------------------------------------- save/load
    # Layout: <dir>/profile.npz (rank/anorms/hessians arrays, keys
    # "<group>/<layer>:<name>") + profile.json (weights, token count,
    # timing), written atomically through the CheckpointManager.

    def save(self, directory: str) -> str:
        mgr = CheckpointManager(directory, keep=1)
        arrays = {}
        groups = [("rank", self.rank), ("anorms", self.anorms)]
        if self.hessians is not None:
            groups.append(("hessians", self.hessians))
        for group, d in groups:
            for (layer, name), v in d.items():
                arrays[f"{group}/{layer}:{name}"] = (
                    v.detach().cpu().numpy() if hasattr(v, "detach")
                    else np.asarray(v))
        mgr.save_arrays(PROFILE_ARRAYS, arrays)
        mgr.save_json(PROFILE_FILE, {
            "kind": "rank_artifact",
            "n_tokens": int(self.n_tokens),
            "profile_seconds": float(self.profile_seconds),
            "has_hessians": self.hessians is not None,
            "weights": [[layer, name, int(v)] for (layer, name), v
                        in sorted(self.weights.items())],
        })
        return directory

    @staticmethod
    def is_artifact(directory: str) -> bool:
        return (os.path.isdir(directory)
                and os.path.exists(os.path.join(directory, PROFILE_FILE))
                and os.path.exists(os.path.join(directory, PROFILE_ARRAYS)))

    @classmethod
    def load(cls, directory: str, device=None) -> "RankArtifact":
        """Load a profile; anorms and Hessians go to ``device`` (``cuda``
        unless the caller asks for another)."""
        if not cls.is_artifact(directory):
            raise FileNotFoundError(
                f"{directory!r} is not a RankArtifact bundle "
                f"(missing {PROFILE_FILE}/{PROFILE_ARRAYS})")
        device = resolve_device(device)
        mgr = CheckpointManager(directory, keep=1)
        meta = mgr.load_json(PROFILE_FILE)
        rank, anorms, hessians = {}, {}, {}
        for key, arr in mgr.load_arrays(PROFILE_ARRAYS).items():
            group, rest = key.split("/", 1)
            layer, name = rest.split(":", 1)
            k = (int(layer), name)
            if group == "rank":
                # scalar ranks round-trip as 0-d arrays -> back to float
                rank[k] = float(arr) if arr.ndim == 0 else arr
            elif group == "anorms":
                anorms[k] = from_numpy(arr, device=device)
            elif group == "hessians":
                hessians[k] = from_numpy(arr, device=device)
        weights = {(int(layer), name): int(v)
                   for layer, name, v in meta["weights"]}
        return cls(rank=rank, anorms=anorms, weights=weights,
                   n_tokens=int(meta["n_tokens"]),
                   profile_seconds=float(meta["profile_seconds"]),
                   hessians=hessians if meta["has_hessians"] else None)


def profile_model(params, cfg: ModelConfig,
                  calibration_batches: Iterable,
                  alpha: float = pod.DEFAULT_ALPHA,
                  want_hessians: bool = False,
                  device=None) -> RankArtifact:
    """RC profiling (the pipeline's ``rank`` stage): one calibration pass
    over the model emits the reusable global rank R_LLM. ``device`` is
    where the calibration tokens go (default: the params' device)."""
    if want_hessians:
        raise NotImplementedError(
            "Hessian profiling (sparsegpt) is not ported yet")
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    device = tree_device(params) if device is None else device
    t0 = time.perf_counter()
    stats, n_tokens = C.calibrate(params, cfg, calibration_batches, device,
                                  mode="ssq")
    anorms = C.activation_norms(stats)
    rank = pod.global_rank(params, cfg, anorms, alpha=alpha)
    weights = {p.key: int(tree_get(params, p.path).numel())
               for p in projections(cfg)}
    return RankArtifact(rank=rank, anorms=anorms, weights=weights,
                        n_tokens=n_tokens,
                        profile_seconds=time.perf_counter() - t0)
