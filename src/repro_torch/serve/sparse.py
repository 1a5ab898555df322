"""Block-sparse serving path: run a Mosaic-pruned (``wanda_block`` /
composite) model's FFN projections through the block-sparse kernel.

``pack_model`` walks the pruned projections once (the PC's Post-Pruning
Optimizer step, Fig. 6 #10) and builds the per-projection block plans;
``sparse_apply_ffn`` executes the feed-forward with zero tiles skipped.
A plan's ``counts``/``indices`` are int32 tensors on the weight's device,
moved there once at pack time. The block map is computed on the device
and only the small ``(K/b, N/b)`` map travels to the host.

A projection whose 2-D fold does not tile by the plan block gets no plan
(``pack_projection`` returns None): it runs dense and the pack report
lists it as ``skipped`` with ``reason: "non-tileable"``. MoE expert
stacks and int8 kept tiles come with their slices.

``plans_to_host`` / ``plans_from_host`` carry the plans through a
bundle's ``plans.npz`` + ``plans.json``, in the JAX package's format.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_get
from repro_torch.core.registry import projections
from repro_torch.kernels.block_sparse.ops import (block_mask_from_weight_mask,
                                                  blocksparse_matmul,
                                                  plan_blocks)
from repro_torch.models.specs import ModelConfig, MoESpec


@dataclasses.dataclass
class PackedProjection:
    """One projection's block plan."""
    counts: torch.Tensor       # (N/bn,) int32, on the weight's device
    indices: torch.Tensor      # (N/bn, max_nnz) int32, edge-padded
    block: int
    density: float             # fraction of nonzero tiles


def pack_projection(w: torch.Tensor,
                    block: int = 128) -> Optional[PackedProjection]:
    """Build the kernel's block plan from a pruned weight. Returns None
    when the (2-D-folded) weight does not tile evenly."""
    w2 = w.reshape(w.shape[0], -1)
    K, N = w2.shape
    if K % block or N % block:
        return None
    bm = block_mask_from_weight_mask(w2 != 0, block, block).cpu().numpy()
    counts, indices = plan_blocks(bm)
    return PackedProjection(
        counts=torch.as_tensor(counts, device=w.device),
        indices=torch.as_tensor(indices, device=w.device), block=block,
        density=float(bm.mean()))


def pack_model_with_report(params, cfg: ModelConfig,
                           block: int = 128) -> tuple:
    """Returns ``(packed, report)``: ``{(layer, name): PackedProjection}``
    for every tileable projection, plus a summary of what was not
    packed, so serve-time coverage is auditable from the report."""
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    packed: dict = {}
    skipped: list = []
    packed_params = 0
    for proj in projections(cfg):
        if proj.expert_axis is not None:
            raise NotImplementedError("expert plan stacks are not ported yet")
        w = tree_get(params, proj.path)
        n = int(w.numel())
        p = pack_projection(w, block)
        if p is None:
            skipped.append({"layer": proj.layer, "name": proj.name,
                            "params": n, "reason": "non-tileable"})
        else:
            packed[proj.key] = p
            packed_params += n
    report = {
        "block": block,
        "n_packed": len(packed),
        "packed_params": packed_params,
        "n_skipped": len(skipped),
        "skipped_params": sum(s["params"] for s in skipped),
        "skipped": skipped,
        "flop_savings": flop_savings(packed),
    }
    if skipped:
        logging.getLogger(__name__).info(
            "pack_model: skipped %d/%d projections (%d params) — %s",
            len(skipped), len(skipped) + len(packed),
            report["skipped_params"],
            ", ".join(sorted({s["reason"] for s in skipped})))
    return packed, report


def pack_model(params, cfg: ModelConfig, block: int = 128) -> dict:
    """{(layer, name): PackedProjection} for every tileable projection."""
    packed, _ = pack_model_with_report(params, cfg, block)
    return packed


def sparse_linear(x: torch.Tensor, w: torch.Tensor,
                  packed: PackedProjection) -> torch.Tensor:
    """y = x @ w through the block-sparse kernel. x: (..., K); w: (K, N).
    The rows are zero-padded to a multiple of the plan block, as the JAX
    package pads them for its kernel's M-blocks."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    pad_m = (-M) % packed.block
    if pad_m:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, pad_m))
    y = blocksparse_matmul(x2.contiguous(), w.reshape(K, -1),
                           packed.counts, packed.indices, packed.block)
    if pad_m:
        y = y[:M]
    return y.reshape(*lead, -1)


def sparse_apply_mlp(block_params: dict, spec, x: torch.Tensor,
                     packed_layer: dict, layer: int) -> torch.Tensor:
    """Feed-forward through the kernel (gate/up/down as available)."""
    from repro_torch.models.layers import activation
    mlp = block_params["mlp"]
    dtype = x.dtype

    def lin(name, inp):
        w = mlp[name].to(dtype)
        key = (layer, name)
        if key in packed_layer:
            return sparse_linear(inp, w, packed_layer[key])
        return inp @ w

    up = lin("up", x)
    if spec.gated:
        h = activation(spec.act, lin("gate", x)) * up
    else:
        h = activation(spec.act, up)
    return lin("down", h)


def sparse_apply_ffn(block_params: dict, spec, x: torch.Tensor,
                     packed: dict, layer: int) -> torch.Tensor:
    """Feed-forward dispatch for the serving ``mlp_apply`` hook."""
    if isinstance(spec, MoESpec):
        raise NotImplementedError("MoE sparse serving is not ported yet")
    return sparse_apply_mlp(block_params, spec, x, packed, layer)


def flop_savings(packed: dict) -> float:
    """Mean fraction of projection FLOPs the kernels skip."""
    if not packed:
        return 0.0
    return float(np.mean([1.0 - p.density for p in packed.values()]))


# ----------------------------------------------- plan (de)serialization
# A bundle keeps the block plans so serve startup rehydrates them instead
# of packing the weights again. Keys and metadata follow the JAX package:
# "<layer>:<name>:counts" / ":indices" arrays, {"block", "density"} meta.
# Expert stacks ("expert") and int8 storage ("quant") come with slices 4
# and 3; until then a bundle that carries them is refused, never served
# with those keys dropped.

def plans_to_host(packed: dict) -> tuple:
    """``(arrays, meta)``: flat npz-able int32 arrays and JSON-able
    metadata of dense ``PackedProjection`` plans."""
    arrays: dict = {}
    meta: dict = {}
    for (layer, name), p in packed.items():
        if not isinstance(p, PackedProjection):
            raise NotImplementedError(
                f"plan {layer}:{name} is a {type(p).__name__}; only dense "
                f"PackedProjection plans are ported")
        key = f"{layer}:{name}"
        arrays[key + ":counts"] = p.counts.cpu().numpy()
        arrays[key + ":indices"] = p.indices.cpu().numpy()
        meta[key] = {"block": p.block, "density": p.density}
    return arrays, meta


def plans_from_host(arrays: dict, meta: dict, device=None) -> dict:
    """Inverse of :func:`plans_to_host`: the ``PackedProjection`` plans,
    their arrays on ``device``. Raises on expert or int8 plans."""
    packed: dict = {}
    for key, m in meta.items():
        if m.get("expert") or m.get("quant", "none") != "none":
            raise NotImplementedError(
                f"plan {key} is an expert stack or int8 storage; only "
                f"dense plans are ported")
        layer, name = key.split(":")
        packed[(int(layer), name)] = PackedProjection(
            counts=torch.tensor(arrays[key + ":counts"], dtype=torch.int32,
                                device=device),
            indices=torch.tensor(arrays[key + ":indices"],
                                 dtype=torch.int32, device=device),
            block=int(m["block"]), density=float(m["density"]))
    return packed
