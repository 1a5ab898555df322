"""Block-sparse serving path: run a Mosaic-pruned (``wanda_block`` /
composite) model's FFN projections through the block-sparse kernels.

``pack_model`` walks the pruned projections once (the PC's Post-Pruning
Optimizer step, Fig. 6 #10) and builds the per-projection block plans,
including a per-expert plan stack for every MoE expert weight;
``sparse_apply_ffn`` executes the feed-forward with zero tiles skipped
(``sparse_apply_mlp`` for dense-MLP layers, ``sparse_apply_moe`` inside
the MoE dispatch). MoE expert matmuls default to the grouped kernel —
all E experts in one launch, driven by the stacked plan — with the
per-expert launch loop through kernel 1 as the ``group_experts=False``
fallback, and the ragged kernel for decode-sized batches with
``ragged_moe``. A plan's ``counts``/``indices`` are int32 tensors on the
weight's device, moved there once at pack time. The block maps are
computed on the device and only the small ``(K/b, N/b)`` maps travel to
the host.

A projection whose 2-D fold does not tile by the plan block gets no plan
(``pack_projection`` returns None): it runs dense and the pack report
lists it as ``skipped`` with ``reason: "non-tileable"``.

``quant="int8"`` packs each plan's kept tiles as int8 with one pow2
scale per tile (``tiles``, ``scales``, ``slots`` ride on the plan; an
expert stack concatenates every expert's tiles with absolute slots), and
the kernels then stream that storage instead of the dense weight: kernel
5 for dense MLPs and the per-expert loop, kernels 8 and 9 for the
grouped and ragged MoE paths. Gathering, quantising and scattering back
(``dequantized_weight``, ``apply_fake_quant``) run on the weight's
device; only the per-tile ``amax`` visits the host, for the scale
exponent (``core/quant.py``).

``plans_to_host`` / ``plans_from_host`` carry the plans through a
bundle's ``plans.npz`` + ``plans.json``, in the JAX package's format.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from repro_torch.common.spans import LOG as SPANS
from repro_torch.common.tree import tree_get, tree_set
from repro_torch.core.quant import quantize_tiles
from repro_torch.core.registry import projections
from repro_torch.kernels.block_sparse.ops import (block_mask_from_weight_mask,
                                                  blocksparse_matmul,
                                                  gather_kept_tiles,
                                                  plan_blocks, plan_slots,
                                                  quant_blocksparse_matmul)
from repro_torch.kernels.block_sparse.ref import dequantize_plan
from repro_torch.kernels.grouped_block_sparse import ops as grouped_ops
from repro_torch.models.specs import ModelConfig, MoESpec


@dataclasses.dataclass
class PackedProjection:
    """One projection's block plan. With ``quant="int8"`` the plan also
    carries its kept tiles as int8 storage, the per-step pow2 scales and
    the slot map naming the storage row of column ``n``'s step ``s``, so
    the serving path never reads the dense weight."""
    counts: torch.Tensor       # (N/bn,) int32, on the weight's device
    indices: torch.Tensor      # (N/bn, max_nnz) int32, edge-padded
    block: int
    density: float             # fraction of nonzero tiles
    quant: str = "none"        # "none" | "int8" (kept-tile storage)
    tiles: Optional[torch.Tensor] = None   # (T, block, block) int8
    scales: Optional[torch.Tensor] = None  # (N/bn, max_nnz) f32 pow2
    slots: Optional[torch.Tensor] = None   # (N/bn, max_nnz) int32 rows


@dataclasses.dataclass
class PackedExpertProjection:
    """A leading-``E`` stack of per-expert block plans for one MoE
    projection. Experts share ``max_nnz`` (each expert's index row is
    edge-padded; the kernels stop at ``counts``), so one stacked plan
    covers the whole expert group even when densities diverge.

    ``group`` selects the serving path: True runs all E experts in one
    grouped kernel launch off this stack; False falls back to E
    per-expert kernel-1 launches through the :meth:`expert` views.
    ``ragged`` additionally sends decode-sized batches through the
    ragged (routed-tokens-only) kernel; the same stacked plan drives
    both."""
    counts: torch.Tensor       # (E, N/bn) int32, on the weight's device
    indices: torch.Tensor      # (E, N/bn, max_nnz) int32, edge-padded
    block: int
    density: float             # mean nonzero-tile fraction over experts
    densities: tuple           # per-expert nonzero-tile fractions
    group: bool = True         # serve through the grouped kernel
    ragged: bool = False       # ragged dispatch for decode-sized batches
    quant: str = "none"        # "none" | "int8" (kept-tile storage)
    tiles: Optional[torch.Tensor] = None   # (T_total, block, block) int8,
    #                                        every expert's kept tiles
    scales: Optional[torch.Tensor] = None  # (E, N/bn, max_nnz) f32 pow2
    slots: Optional[torch.Tensor] = None   # (E, N/bn, max_nnz) int32,
    #                                        absolute rows into ``tiles``

    @property
    def n_experts(self) -> int:
        return int(self.counts.shape[0])

    def expert(self, e: int) -> PackedProjection:
        """The expert-``e`` plan that kernel 1 (or kernel 5) takes. An
        int8 stack hands the whole tile array to every view: the slots
        are absolute, so a view reaches only its own expert's tiles."""
        return PackedProjection(counts=self.counts[e],
                                indices=self.indices[e], block=self.block,
                                density=float(self.densities[e]),
                                quant=self.quant, tiles=self.tiles,
                                scales=(None if self.scales is None
                                        else self.scales[e]),
                                slots=(None if self.slots is None
                                       else self.slots[e]))


def _quantize_plan(w: torch.Tensor, counts: torch.Tensor,
                   indices: torch.Tensor, block: int) -> tuple:
    """Kept-tile int8 storage for one planned weight, ``w`` (K, N) with
    its plan or an expert stack (E, K, N) with the stacked plan: the
    gathered tiles quantised with pow2 per-tile scales, plus the slot
    and scale maps shaped like ``indices`` (dead steps take the clamped
    tile's slot and scale). Returns ``(q, scales, slots)`` on ``w``'s
    device. An expert stack's slots are absolute rows of the
    concatenated storage, every expert starting where the one before it
    ends, as the JAX package lays them out."""
    q, tile_scales = quantize_tiles(
        gather_kept_tiles(w, counts, indices, block))
    slots, total = plan_slots(counts, indices.shape[-1])
    if slots.ndim == 3:                    # expert e starts past e' < e
        rows = np.maximum(total, 1)
        slots = slots + (np.cumsum(rows) - rows)[:, None, None].astype(
            np.int32)
    if slots.size and int(slots.max()) >= q.shape[0]:
        raise AssertionError(f"slot {int(slots.max())} past the "
                             f"{q.shape[0]} stored tiles")
    slots = torch.as_tensor(slots, device=w.device)
    return q, tile_scales[slots.long()], slots


def pack_projection(w: torch.Tensor, block: int = 128,
                    quant: str = "none") -> Optional[PackedProjection]:
    """Build the kernel's block plan from a pruned weight. Returns None
    when the (2-D-folded) weight does not tile evenly. ``quant="int8"``
    also packs the kept tiles as int8 storage riding the plan."""
    w2 = w.reshape(w.shape[0], -1)
    K, N = w2.shape
    if K % block or N % block:
        return None
    bm = block_mask_from_weight_mask(w2 != 0, block, block).cpu().numpy()
    counts, indices = plan_blocks(bm)
    p = PackedProjection(
        counts=torch.as_tensor(counts, device=w.device),
        indices=torch.as_tensor(indices, device=w.device), block=block,
        density=float(bm.mean()), quant=quant)
    if quant == "int8":
        p.tiles, p.scales, p.slots = _quantize_plan(w2, p.counts, p.indices,
                                                    block)
    return p


def pack_expert_projection(w: torch.Tensor, block: int = 128,
                           group: bool = True, ragged: bool = False,
                           quant: str = "none"
                           ) -> Optional[PackedExpertProjection]:
    """Per-expert block plans for an ``(E, K, ...)`` MoE weight. Each
    expert's 2-D fold is planned independently; index rows are padded to
    the largest ``max_nnz`` across experts so the stack is rectangular.
    Returns None when an expert's fold does not tile evenly.
    ``quant="int8"`` concatenates every expert's kept tiles into one int8
    array with absolute slot rows, for kernels 8 and 9."""
    E = w.shape[0]
    w3 = w.reshape(E, w.shape[1], -1)
    K, N = w3.shape[1], w3.shape[2]
    if K % block or N % block:
        return None
    bms = block_mask_from_weight_mask(w3 != 0, block, block).cpu().numpy()
    plans = [plan_blocks(bm) for bm in bms]
    counts, indices = grouped_ops.stack_expert_plans(
        [c for c, _ in plans], [i for _, i in plans])
    densities = tuple(float(bm.mean()) for bm in bms)
    p = PackedExpertProjection(
        counts=torch.as_tensor(counts, device=w.device),
        indices=torch.as_tensor(indices, device=w.device), block=block,
        density=float(np.mean(densities)), densities=densities,
        group=group, ragged=ragged, quant=quant)
    if quant == "int8":
        p.tiles, p.scales, p.slots = _quantize_plan(w3, p.counts, p.indices,
                                                    block)
    return p


def quant_plan_bytes(packed: dict, params=None, cfg=None) -> dict:
    """Storage of the int8 kept-tile plans: per projection the int8 tile
    bytes, f32 scale-map bytes and int32 plan bytes, beside the
    projection's dense bytes and a bf16 dense reference (the JAX
    package's accounting, key for key)."""
    per: dict = {}
    dense_lookup = {}
    if params is not None and cfg is not None:
        c = cfg if not cfg.scan_layers else cfg.unrolled()
        for proj in projections(c):
            dense_lookup[proj.key] = tree_get(params, proj.path)
    for key, p in packed.items():
        if p.quant != "int8" or p.tiles is None:
            continue
        tile_bytes = int(p.tiles.numel())                   # int8
        scale_bytes = int(p.scales.numel()) * 4
        plan_bytes = (int(p.counts.numel()) + int(p.indices.numel())
                      + int(p.slots.numel())) * 4
        row = {"tile_bytes": tile_bytes, "scale_bytes": scale_bytes,
               "plan_bytes": plan_bytes,
               "bytes": tile_bytes + scale_bytes + plan_bytes}
        w = dense_lookup.get(key)
        if w is not None:
            row["dense_bytes"] = int(w.numel()) * w.element_size()
            row["bf16_bytes"] = int(w.numel()) * 2
        per[f"{key[0]}:{key[1]}"] = row
    total = sum(r["bytes"] for r in per.values())
    dense = sum(r.get("dense_bytes", 0) for r in per.values())
    bf16 = sum(r.get("bf16_bytes", 0) for r in per.values())
    return {"per_projection": per, "total_bytes": total,
            "dense_bytes": dense, "bf16_bytes": bf16,
            "ratio_vs_bf16": (total / bf16 if bf16 else 0.0)}


def pack_model_with_report(params, cfg: ModelConfig, block: int = 128,
                           group_experts: bool = True,
                           ragged_moe: bool = False,
                           quant: str = "none") -> tuple:
    """Returns ``(packed, report)``: ``{(layer, name): PackedProjection |
    PackedExpertProjection}`` for every tileable projection, plus a
    summary of what was not packed, so serve-time coverage is auditable
    from the report. ``group_experts`` / ``ragged_moe`` mark the expert
    stacks' serving paths; ``quant="int8"`` packs int8 kept-tile storage
    into every plan and reports its bytes (``quant_bytes``)."""
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    packed: dict = {}
    skipped: list = []
    packed_params = 0
    for proj in projections(cfg):
        w = tree_get(params, proj.path)
        n = int(w.numel())
        if proj.expert_axis is not None:
            p = pack_expert_projection(w, block, group=group_experts,
                                       ragged=ragged_moe, quant=quant)
        else:
            p = pack_projection(w, block, quant=quant)
        if p is None:
            skipped.append({"layer": proj.layer, "name": proj.name,
                            "params": n, "reason": "non-tileable"})
        else:
            packed[proj.key] = p
            packed_params += n
    n_expert = sum(isinstance(p, PackedExpertProjection)
                   for p in packed.values())
    report = {
        "block": block,
        "group_experts": group_experts,
        "ragged_moe": ragged_moe,
        "quant": quant,
        "n_packed": len(packed),
        "n_expert_packed": n_expert,
        "packed_params": packed_params,
        "n_skipped": len(skipped),
        "skipped_params": sum(s["params"] for s in skipped),
        "skipped": skipped,
        "flop_savings": flop_savings(packed),
    }
    if quant == "int8":
        report["quant_bytes"] = quant_plan_bytes(packed, params, cfg)
    if skipped:
        logging.getLogger(__name__).info(
            "pack_model: skipped %d/%d projections (%d params) — %s",
            len(skipped), len(skipped) + len(packed),
            report["skipped_params"],
            ", ".join(sorted({s["reason"] for s in skipped})))
    return packed, report


def pack_model(params, cfg: ModelConfig, block: int = 128,
               group_experts: bool = True, ragged_moe: bool = False,
               quant: str = "none") -> dict:
    """{(layer, name): PackedProjection | PackedExpertProjection} for
    every tileable projection (MoE expert weights get plan stacks)."""
    packed, _ = pack_model_with_report(params, cfg, block,
                                       group_experts=group_experts,
                                       ragged_moe=ragged_moe, quant=quant)
    return packed


def dequantized_weight(p, K: int) -> torch.Tensor:
    """The fake-quant dense weight an int8 plan encodes, f32 on the
    plan's device: the dequantised kept tiles scattered into zeros,
    (K, N) for a ``PackedProjection``, (E, K, N) for an expert stack.
    The unquantized kernels over it are the int8 kernels' reference,
    bitwise (pow2 scales)."""
    if p.quant != "int8" or p.tiles is None:
        raise ValueError("dequantized_weight needs a plan with int8 "
                         "kept-tile storage")
    return dequantize_plan(p.tiles, p.counts, p.indices, p.slots, p.scales,
                           K // p.block)


def apply_fake_quant(params, cfg: ModelConfig, packed: dict):
    """Replace every int8 plan's projection weight with its dequantised
    kept tiles, so the dense forward, the ``quant="none"`` path and the
    int8 kernels all compute with the same weights. Pruned tiles are
    zero by construction of the plan, so nothing else is lost. Runs on
    the weights' device."""
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    for proj in projections(cfg):
        p = packed.get(proj.key)
        if p is None or p.quant != "int8":
            continue
        w = tree_get(params, proj.path)
        K = w.shape[1] if isinstance(p, PackedExpertProjection) \
            else w.shape[0]
        wq = dequantized_weight(p, K)
        params = tree_set(params, proj.path,
                          wq.reshape(w.shape).to(w.device, w.dtype))
    return params


def _use_quant(plan, quant: Optional[str]) -> bool:
    """The serve-time quant override against the plan: None follows the
    plan's own flag, "none" forces the dense-weight reference path,
    "int8" requires kept-tile storage."""
    has = plan.quant == "int8" and plan.tiles is not None
    if quant == "int8" and not has:
        raise ValueError("quant='int8' requested but the plan carries no "
                         "int8 kept-tile storage (pack with "
                         "PruneRecipe.quant='int8')")
    return has if quant is None else quant == "int8"


def sparse_linear(x: torch.Tensor, w: torch.Tensor,
                  packed: PackedProjection,
                  quant: Optional[str] = None) -> torch.Tensor:
    """y = x @ w through the block-sparse kernel. x: (..., K); w: (K, N).
    The rows are zero-padded to a multiple of the plan block, as the JAX
    package pads them for its kernel's M-blocks. An int8 plan streams
    its kept tiles through kernel 5 instead of ``w`` (``quant`` overrides
    the plan's flag: "none" forces kernel 1 over ``w``)."""
    lead = x.shape[:-1]
    K = x.shape[-1]
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    pad_m = (-M) % packed.block
    if pad_m:
        x2 = torch.nn.functional.pad(x2, (0, 0, 0, pad_m))
    if _use_quant(packed, quant):
        y = quant_blocksparse_matmul(x2.contiguous(), packed.tiles,
                                     packed.counts, packed.indices,
                                     packed.slots, packed.scales,
                                     packed.block)
    else:
        y = blocksparse_matmul(x2.contiguous(), w.reshape(K, -1),
                               packed.counts, packed.indices, packed.block)
    if pad_m:
        y = y[:M]
    return y.reshape(*lead, -1)


def sparse_apply_mlp(block_params: dict, spec, x: torch.Tensor,
                     packed_layer: dict, layer: int,
                     quant: Optional[str] = None) -> torch.Tensor:
    """Feed-forward through the kernel (gate/up/down as available)."""
    from repro_torch.models.layers import activation
    mlp = block_params["mlp"]
    dtype = x.dtype

    def lin(name, inp):
        w = mlp[name].to(dtype)
        key = (layer, name)
        if key in packed_layer:
            return sparse_linear(inp, w, packed_layer[key], quant=quant)
        return inp @ w

    up = lin("up", x)
    if spec.gated:
        h = activation(spec.act, lin("gate", x)) * up
    else:
        h = activation(spec.act, up)
    return lin("down", h)


def grouped_sparse_linear(xs: torch.Tensor, ws: torch.Tensor,
                          packed: PackedExpertProjection,
                          row_live: Optional[torch.Tensor] = None,
                          quant: Optional[str] = None) -> torch.Tensor:
    """y[e] = x[e] @ w[e] for all experts in one grouped kernel launch.
    xs: (E, M, K); ws: (E, K, ...) — trailing dims folded to N. Up to
    ``PANEL_ROWS_MAX`` rows the panel is padded to 16 rows and is one
    occupancy block; above, it is padded to and tiled by the plan block.
    ``row_live`` ((E, M) bool, optional): router occupancy — experts and
    M-blocks with no live row are written as zeros without being
    computed (live rows are unchanged). An int8 stack runs kernel 8 over
    its storage (``quant`` as in :func:`sparse_linear`)."""
    E, M, K = xs.shape
    bm = packed.block
    pad_m = (-M) % (16 if M <= grouped_ops.PANEL_ROWS_MAX else bm)
    if pad_m:
        xs = torch.nn.functional.pad(xs, (0, 0, 0, pad_m))
        if row_live is not None:
            row_live = torch.nn.functional.pad(row_live, (0, pad_m))
    block_m = None if M <= grouped_ops.PANEL_ROWS_MAX else bm
    if _use_quant(packed, quant):
        y = grouped_ops.quant_grouped_blocksparse_matmul(
            xs.contiguous(), packed.tiles, packed.counts, packed.indices,
            packed.slots, packed.scales, bm, block_m=block_m,
            row_live=row_live)
    else:
        y = grouped_ops.grouped_blocksparse_matmul(
            xs.contiguous(), ws.reshape(E, K, -1), packed.counts,
            packed.indices, bm, block_m=block_m, row_live=row_live)
    if pad_m:
        y = y[:, :M]
    return y


def ragged_sparse_linear(xp: torch.Tensor, ws: torch.Tensor,
                         tile_expert: torch.Tensor,
                         packed: PackedExpertProjection,
                         quant: Optional[str] = None) -> torch.Tensor:
    """The ragged expert batch through the stacked tile plan in one
    launch. xp: (M, K) routed tokens packed into 16-row-aligned
    per-expert segments (M a multiple of 16, which the dispatch's static
    bound guarantees); ws: (E, K, ...) — trailing dims folded to N;
    tile_expert: (M / 16,) owner map, -1 on dead padding tiles. An int8
    stack runs kernel 9 over its storage."""
    M, K = xp.shape
    if M % grouped_ops.RAGGED_BLOCK_ROWS:
        raise ValueError(f"ragged batch of {M} rows is not a multiple of "
                         f"{grouped_ops.RAGGED_BLOCK_ROWS}")
    if _use_quant(packed, quant):
        return grouped_ops.quant_ragged_blocksparse_matmul(
            xp.contiguous(), packed.tiles, packed.counts, packed.indices,
            packed.slots, packed.scales, tile_expert, packed.block)
    return grouped_ops.ragged_blocksparse_matmul(
        xp.contiguous(), ws.reshape(ws.shape[0], K, -1), packed.counts,
        packed.indices, tile_expert, packed.block)


# Largest token count (B*S at the layer input) served through the ragged
# kernel: decode ticks qualify, prefill-sized batches fall back to the
# grouped capacity-slot launch (whose panels are mostly occupied anyway).
RAGGED_TOKENS_MAX = 64


def sparse_apply_moe(block_params: dict, spec, x: torch.Tensor,
                     packed_layer: dict, layer: int,
                     group_experts: Optional[bool] = None,
                     ragged_moe: Optional[bool] = None,
                     quant: Optional[str] = None) -> torch.Tensor:
    """MoE feed-forward with the expert matmuls run through the
    block-sparse kernels under the layer's per-expert plan stacks.
    Routing, dispatch and combine are ``moe.apply_moe``'s own; only the
    expert matmuls are overridden.

    ``group_experts=None`` follows the plans' own ``group`` flag: True
    runs all E experts in one grouped launch per projection, masked by
    the router's occupancy; False loops E per-expert kernel-1 launches
    (the fallback, and the reference in equivalence checks).
    ``ragged_moe=None`` follows the plans' ``ragged`` flag: when set and
    the batch is decode-sized (``B*S <= RAGGED_TOKENS_MAX``), the
    capacity-slot dispatch is replaced by the ragged expert batch of
    routed tokens only. All paths give the same served rows. ``quant``
    picks the weight storage the kernels stream (see
    :func:`sparse_apply_ffn`)."""
    from repro_torch.models.moe import apply_moe
    plans = [p for p in (packed_layer.get((layer, nm))
                         for nm in ("gate", "up", "down"))
             if isinstance(p, PackedExpertProjection)]
    if not plans:
        y, _ = apply_moe(block_params["moe"], spec, x)
        return y
    if group_experts is None:
        group_experts = all(p.group for p in plans)
    if ragged_moe is None:
        ragged_moe = all(p.ragged for p in plans)

    n_tokens = int(x.shape[0]) * int(x.shape[1])
    if ragged_moe and n_tokens <= RAGGED_TOKENS_MAX:
        def expert_ragged_linear(name, xp, ws, tile_expert):
            plan = packed_layer.get((layer, name))
            if isinstance(plan, PackedExpertProjection):
                return ragged_sparse_linear(xp, ws, tile_expert, plan,
                                            quant=quant)
            # no plan for this projection: each tile times its expert
            rows = grouped_ops.RAGGED_BLOCK_ROWS
            owner = tile_expert.clamp(min=0).long()
            return torch.bmm(xp.reshape(-1, rows, xp.shape[1]),
                             ws[owner]).reshape(xp.shape[0], -1)

        y, _ = apply_moe(block_params["moe"], spec, x,
                         expert_ragged_linear=expert_ragged_linear)
        return y

    if group_experts:
        def expert_group_linear(name, xs, ws, row_live):
            plan = packed_layer.get((layer, name))
            if isinstance(plan, PackedExpertProjection):
                return grouped_sparse_linear(xs, ws, plan, row_live=row_live,
                                             quant=quant)
            return torch.bmm(xs, ws)

        y, _ = apply_moe(block_params["moe"], spec, x,
                         expert_group_linear=expert_group_linear)
        return y

    def expert_linear(name, e, xe, we):
        plan = packed_layer.get((layer, name))
        if isinstance(plan, PackedExpertProjection):
            return sparse_linear(xe, we, plan.expert(e), quant=quant)
        return xe @ we

    y, _ = apply_moe(block_params["moe"], spec, x,
                     expert_linear=expert_linear)
    return y


def sparse_apply_ffn(block_params: dict, spec, x: torch.Tensor,
                     packed: dict, layer: int,
                     group_experts: Optional[bool] = None,
                     ragged_moe: Optional[bool] = None,
                     quant: Optional[str] = None) -> torch.Tensor:
    """Feed-forward dispatch for the serving ``mlp_apply`` hook: dense-MLP
    layers through :func:`sparse_apply_mlp`, MoE layers through
    :func:`sparse_apply_moe` (grouped by default, the per-expert loop
    with ``group_experts=False``, ragged decode with ``ragged_moe``).
    ``quant`` picks the weight storage the kernels stream: None follows
    each plan's own flag, "int8" requires kept-tile storage, "none"
    forces the dense-weight (dequantised reference) path."""
    k = SPANS.open("ffn") if SPANS.on else -1
    if isinstance(spec, MoESpec):
        y = sparse_apply_moe(block_params, spec, x, packed, layer,
                             group_experts=group_experts,
                             ragged_moe=ragged_moe, quant=quant)
    else:
        y = sparse_apply_mlp(block_params, spec, x, packed, layer,
                             quant=quant)
    if k >= 0:
        SPANS.close(k)
    return y


def flop_savings(packed: dict) -> float:
    """Mean fraction of projection FLOPs the kernels skip. An expert
    stack contributes one term per expert (each expert's matmul is a
    whole projection's worth of FLOPs), not one per stack."""
    if not packed:
        return 0.0
    skipped = []
    for p in packed.values():
        if isinstance(p, PackedExpertProjection):
            skipped.extend(1.0 - d for d in p.densities)
        else:
            skipped.append(1.0 - p.density)
    return float(np.mean(skipped))


# ----------------------------------------------- plan (de)serialization
# A bundle keeps the block plans so serve startup rehydrates them instead
# of packing the weights again. Keys and metadata follow the JAX package:
# "<layer>:<name>:counts" / ":indices" arrays, {"block", "density"} meta;
# an expert stack adds {"expert": true, "densities", "group", "ragged"}
# and its arrays carry the leading E axis. An int8 plan adds {"quant":
# "int8"} and its ":tiles" (int8), ":scales" (f32) and ":slots" (int32)
# arrays.

def plans_to_host(packed: dict) -> tuple:
    """``(arrays, meta)``: flat npz-able int32 arrays and JSON-able
    metadata of ``PackedProjection`` plans and expert plan stacks."""
    arrays: dict = {}
    meta: dict = {}
    for (layer, name), p in packed.items():
        key = f"{layer}:{name}"
        arrays[key + ":counts"] = p.counts.cpu().numpy()
        arrays[key + ":indices"] = p.indices.cpu().numpy()
        meta[key] = {"block": p.block, "density": p.density}
        if isinstance(p, PackedExpertProjection):
            meta[key].update(expert=True, densities=list(p.densities),
                             group=bool(p.group), ragged=bool(p.ragged))
        if p.quant == "int8" and p.tiles is not None:
            meta[key]["quant"] = p.quant
            arrays[key + ":tiles"] = p.tiles.cpu().numpy()
            arrays[key + ":scales"] = p.scales.cpu().numpy()
            arrays[key + ":slots"] = p.slots.cpu().numpy()
    return arrays, meta


def plans_from_host(arrays: dict, meta: dict, device=None) -> dict:
    """Inverse of :func:`plans_to_host`: the ``PackedProjection`` /
    ``PackedExpertProjection`` plans, their arrays (int8 storage
    included) on ``device``."""
    packed: dict = {}
    for key, m in meta.items():
        layer, name = key.split(":")
        counts = torch.tensor(arrays[key + ":counts"], dtype=torch.int32,
                              device=device)
        indices = torch.tensor(arrays[key + ":indices"], dtype=torch.int32,
                               device=device)
        quant_kw: dict = {"quant": str(m.get("quant", "none"))}
        if quant_kw["quant"] == "int8":
            tiles = arrays[key + ":tiles"]
            slots = arrays[key + ":slots"]
            if slots.size and int(slots.max()) >= tiles.shape[0]:
                raise ValueError(f"plan {key}: slot {int(slots.max())} "
                                 f"past its {tiles.shape[0]} tiles")
            quant_kw.update(
                tiles=torch.tensor(tiles, dtype=torch.int8, device=device),
                scales=torch.tensor(arrays[key + ":scales"],
                                    dtype=torch.float32, device=device),
                slots=torch.tensor(slots, dtype=torch.int32, device=device))
        if m.get("expert"):
            packed[(int(layer), name)] = PackedExpertProjection(
                counts=counts, indices=indices, block=int(m["block"]),
                density=float(m["density"]),
                densities=tuple(float(d) for d in m["densities"]),
                group=bool(m.get("group", True)),
                ragged=bool(m.get("ragged", False)), **quant_kw)
        else:
            packed[(int(layer), name)] = PackedProjection(
                counts=counts, indices=indices, block=int(m["block"]),
                density=float(m["density"]), **quant_kw)
    return packed
