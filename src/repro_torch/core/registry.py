"""Projection registry: enumerates every prunable projection of a model.

A *projection* (the paper's smallest LLM unit) is a 2-D+ weight with a
defined input-activation tap. The registry maps each to its param path,
tap name, and input-channel axes so POD / pruning are model-agnostic.

Operates on unrolled configs (``cfg.unrolled()``): ranking and pruning are
per-layer by definition (Eq. 2), so scanned stacks are unrolled first.

Also hosts the plug-in registries the declarative pipeline dispatches
through: mask *selectors* (magnitude / wanda / wanda_block / sparsegpt),
pruning *categories* (unstructured / structured / composite), and
pipeline *stages* (rank / plan / prune / pack / report). Implementations
self-register from their home modules, so adding a selector or category
is one decorated function — no if/elif chain to extend.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig, MoESpec)


class Registry:
    """Named plug-in table with decorator registration."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: dict[str, Callable] = {}

    def register(self, name: str) -> Callable:
        def deco(fn: Callable) -> Callable:
            if name in self._entries:
                raise ValueError(f"duplicate {self.kind} {name!r}")
            self._entries[name] = fn
            return fn
        return deco

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(f"unknown {self.kind} {name!r}; "
                           f"registered: {sorted(self._entries)}") from None

    def names(self) -> list:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


# selector(w, proj, target, ctx) -> (new_w, mask); ctx: SelectorContext
SELECTORS = Registry("selector")
# category(params, cfg, targets, artifact, recipe) -> (params, cfg, info)
CATEGORIES = Registry("category")
# stage(ctx: PipelineContext) -> None (mutates ctx)
STAGES = Registry("stage")

register_selector = SELECTORS.register
register_category = CATEGORIES.register
register_stage = STAGES.register

# Canonical projection names per mixer/ffn kind, in paper order
# {Q, K, V, O, G, U, D}.
ATTN_PROJS = ("q", "k", "v", "o")
MLP_PROJS = ("gate", "up", "down")
MAMBA_PROJS = ("in_proj", "out_proj")


@dataclass(frozen=True)
class Projection:
    layer: int
    name: str                 # q|k|v|o|gate|up|down|in_proj|out_proj
    path: tuple               # param path, e.g. ('blocks', 3, 'attn', 'q')
    tap: str                  # activation tap supplying ||A||_2
    in_axes: tuple            # weight axes that are input channels
    expert_axis: Optional[int] = None   # leading expert axis for MoE weights

    @property
    def key(self) -> tuple:
        return (self.layer, self.name)


def layer_projections(i: int, spec: LayerSpec) -> list[Projection]:
    projs: list[Projection] = []
    base = ("blocks", i)
    if isinstance(spec.mixer, AttentionSpec):
        for nm in ("q", "k", "v"):
            projs.append(Projection(i, nm, base + ("attn", nm), "attn_qkv", (0,)))
        projs.append(Projection(i, "o", base + ("attn", "o"), "attn_o", (0, 1)))
    else:
        projs.append(Projection(i, "in_proj", base + ("mamba", "in_proj"),
                                "mamba_in", (0,)))
        projs.append(Projection(i, "out_proj", base + ("mamba", "out_proj"),
                                "mamba_out", (0,)))
    if isinstance(spec.ffn, MoESpec):
        names = ("gate", "up") if spec.ffn.gated else ("up",)
        for nm in names:
            projs.append(Projection(i, nm, base + ("moe", nm), "moe_in", (1,),
                                    expert_axis=0))
        projs.append(Projection(i, "down", base + ("moe", "down"), "moe_down",
                                (1,), expert_axis=0))
    elif isinstance(spec.ffn, MLPSpec):
        names = ("gate", "up") if spec.ffn.gated else ("up",)
        for nm in names:
            projs.append(Projection(i, nm, base + ("mlp", nm), "mlp_in", (0,)))
        projs.append(Projection(i, "down", base + ("mlp", "down"), "mlp_down", (0,)))
    return projs


def projections(cfg: ModelConfig) -> list[Projection]:
    assert not cfg.scan_layers, (
        "projection registry operates on unrolled configs; call cfg.unrolled()")
    out: list[Projection] = []
    for i, spec in enumerate(cfg.layers()):
        out.extend(layer_projections(i, spec))
    return out


def tap_sequence(spec: LayerSpec) -> list[str]:
    """The deterministic tap order emitted by one layer's forward."""
    seq = (["attn_qkv", "attn_o"] if isinstance(spec.mixer, AttentionSpec)
           else ["mamba_in", "mamba_out"])
    if isinstance(spec.ffn, MoESpec):
        seq += ["moe_in", "moe_down"]
    elif isinstance(spec.ffn, MLPSpec):
        seq += ["mlp_in", "mlp_down"]
    return seq
