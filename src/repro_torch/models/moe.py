"""Capacity-based top-k Mixture-of-Experts (GShard/Switch formulation).

Gather/scatter dispatch with a fixed per-expert capacity: tokens are
routed within their group (one group per sequence), scattered into
(G, E, C, d) capacity slots, run through the experts, and gathered back
with their gate weights. Under an active mesh (``distributed/axes.py``)
routing, dispatch and combine run per data shard on each rank's local
groups (groups come from the batch, so each shard's groups are its
own), and the expert FFNs on each rank's slots laid out ``('batch',
'experts', None, None)``, as the JAX package hints them.

Serving adds two occupancy-aware dispatch shapes on top (the
``expert_group_linear`` / ``expert_ragged_linear`` hooks):

* the grouped (capacity-slot) path hands its hook the per-(group,
  expert) kept counts as a ``row_live`` mask, so the grouped kernel
  skips experts with no routed token and padded capacity slots;
* the ragged path drops capacity slots: :func:`build_ragged_dispatch`
  packs only routed tokens into a buffer of ``RAGGED_BLOCK_ROWS``-
  aligned per-expert segments (offsets from a cumsum of router counts),
  within the static :func:`ragged_rows_bound` row budget.

Dispatch adds into a buffer one row longer than the slots, whose last
row is the dump row of dropped assignments; combine appends a zero row
and indexes it for them. A drop is never remapped to -1: torch's
indexing, like ``jnp.take``, wraps negative indices, which would leak
another token's output into the dropped assignment.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import hint
from repro_torch.models.layers import (_randn, activation, apply_mlp,
                                       init_mlp)
from repro_torch.models.specs import MLPSpec, MoESpec
from repro_torch.models.taps import tap


def init_moe(gen: Optional[torch.Generator], d_model: int, spec: MoESpec,
             dtype=torch.float32) -> dict:
    """Params on ``gen``'s device (``meta`` tensors when ``gen`` is
    None), drawn in a fixed order: router, up, down, gate, shared."""
    E, Fd = spec.n_experts, spec.d_ff
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(Fd)
    p = {
        "router": _randn(gen, (d_model, E), s_in, dtype),
        "up": _randn(gen, (E, d_model, Fd), s_in, dtype),
        "down": _randn(gen, (E, Fd, d_model), s_out, dtype),
    }
    if spec.gated:
        p["gate"] = _randn(gen, (E, d_model, Fd), s_in, dtype)
    if spec.n_shared:
        shared_spec = MLPSpec(d_ff=Fd * spec.n_shared, act=spec.act,
                              gated=spec.gated)
        p["shared"] = init_mlp(gen, d_model, shared_spec, dtype)
    return p


def capacity(spec: MoESpec, n_tokens: int) -> int:
    """Per-expert dispatch slots. Clamped to >= 1 *before* the rounding
    to 4: at tiny decode batches ``capacity_factor * top_k * n_tokens /
    n_experts`` rounds toward zero, and a zero capacity would silently
    drop every token."""
    c = max(1, int(math.ceil(
        spec.capacity_factor * spec.top_k * n_tokens / spec.n_experts)))
    return max(4, ((c + 3) // 4) * 4)


def n_groups(B: int, S: int) -> int:
    """Dispatch groups: one per sequence of the batch."""
    return B


# M-tile height of the ragged expert-packed buffer: per-expert segments
# start on multiples of it, so every ragged-kernel tile belongs to one
# expert. Equal to the kernel ops' RAGGED_BLOCK_ROWS.
RAGGED_BLOCK_ROWS = 16


def ragged_rows_bound(n_experts: int, n_assign: int) -> int:
    """Static row budget of the ragged packed buffer: ``n_assign`` kept
    assignments at most, plus up to ``RAGGED_BLOCK_ROWS - 1`` alignment
    rows for each expert that can be non-empty, rounded up to a whole
    tile."""
    A = RAGGED_BLOCK_ROWS
    m = n_assign + min(n_experts, n_assign) * (A - 1)
    return ((m + A - 1) // A) * A


def build_ragged_dispatch(flat_ids: torch.Tensor, keep: torch.Tensor,
                          pos: torch.Tensor, n_experts: int, m_max: int):
    """Layout of the ragged expert batch.

    flat_ids / keep / pos: (G, s*K) per-group router assignments —
    expert id, capacity-kept mask, and position within (group, expert).
    Returns ``(dest, tile_expert, counts_e)``:

    * ``dest (G, s*K)`` — packed-buffer row of each assignment (the dump
      row ``m_max`` for capacity-dropped ones). Within expert ``e``,
      group ``g``'s kept rows land at ``offset[e] + sum_{g'<g}
      counts[g', e] + pos``: contiguous per expert, group-major, in
      capacity order.
    * ``tile_expert (m_max / RAGGED_BLOCK_ROWS,)`` int32 — owning expert
      of each tile, from a right-sided searchsorted over the aligned
      segment ends; ``-1`` past the packed total.
    * ``counts_e (E,)`` — kept assignments per expert.
    """
    A = RAGGED_BLOCK_ROWS
    onehot = F.one_hot(flat_ids.long(), n_experts)
    kept = onehot * keep[..., None].long()
    count_ge = kept.sum(dim=1)                           # (G, E)
    inter = torch.cumsum(count_ge, dim=0) - count_ge     # earlier groups
    counts_e = count_ge.sum(dim=0)                       # (E,)
    seg = ((counts_e + A - 1) // A) * A                  # aligned segments
    ends = torch.cumsum(seg, dim=0)
    off = ends - seg                                     # segment starts
    ids = flat_ids.long()
    inter_gi = torch.gather(inter, 1, ids)
    dest = torch.where(keep, off[ids] + inter_gi + pos.long(),
                       torch.full_like(ids, m_max))
    tile_starts = torch.arange(m_max // A, device=ends.device) * A
    e_t = torch.searchsorted(ends, tile_starts, right=True)
    tile_expert = torch.where(e_t < n_experts, e_t,
                              torch.full_like(e_t, -1)).to(torch.int32)
    return dest, tile_expert, counts_e


def apply_moe(params: dict, spec: MoESpec, x: torch.Tensor,
              expert_linear=None, expert_group_linear=None,
              expert_ragged_linear=None):
    """x: (B, S, d). Returns (y, aux_loss).

    ``expert_linear``: optional ``(name, e, x2, w) -> y2`` override for
    the per-expert matmuls (``x2``: the expert's flattened slots, ``w``:
    its 2-D weight) — one kernel launch per expert.

    ``expert_group_linear``: optional ``(name, xs, ws, row_live) -> ys``
    override for the stacked expert matmuls (``xs`` (E, G·C, d), ``ws``
    the (E, d_in, d_out) stack, ``row_live`` (E, G·C) bool: which slots
    hold a routed token) — all E experts in one launch. Takes precedence
    over ``expert_linear``.

    ``expert_ragged_linear``: optional ``(name, xp, ws, tile_expert) ->
    yp`` override on the ragged batch ``xp (m_max, d_in)`` of routed
    tokens only (see :func:`build_ragged_dispatch`). Highest precedence.

    Every path computes each routed token's expert matmuls with the same
    per-row products and combine weights. The default path is the
    stacked einsum, the only one that feeds the calibration taps.
    """
    dtype = x.dtype
    dev = x.device
    B, S, d = x.shape
    E, K = spec.n_experts, spec.top_k
    G = n_groups(B, S)
    s = (B * S) // G
    C = capacity(spec, s)
    xg = x.reshape(G, s, d)
    if AX.active_mesh() is not None:
        if expert_linear or expert_group_linear or expert_ragged_linear:
            raise NotImplementedError("the MoE serving hooks take no mesh")
        return _apply_moe_sharded(params, spec, xg, C, (B, S, d))

    probs, expert_ids, gate_vals, flat_ids, onehot, pos, keep, slot = \
        _route(xg, params["router"].to(dtype), spec, C)

    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    src = xg.repeat_interleave(K, dim=1)                     # (G, sK, d)

    if expert_ragged_linear is not None:
        m_max = ragged_rows_bound(E, G * s * K)
        dest, tile_expert, _ = build_ragged_dispatch(flat_ids, keep, pos,
                                                     E, m_max)
        flat_dest = dest.reshape(-1)
        xp = torch.zeros((m_max + 1, d), dtype=dtype, device=dev)
        xp = xp.index_add_(0, flat_dest, src.reshape(-1, d))[:m_max]
        up = expert_ragged_linear("up", xp, params["up"].to(dtype),
                                  tile_expert)
        if spec.gated:
            g = activation(spec.act, expert_ragged_linear(
                "gate", xp, params["gate"].to(dtype), tile_expert))
            h = g * up
        else:
            h = activation(spec.act, up)
        out = expert_ragged_linear("down", h, params["down"].to(dtype),
                                   tile_expert)
        # combine: dropped assignments carry dest == m_max, the appended
        # zero row
        out = torch.cat([out, out.new_zeros((1, d))])
        gathered = out[flat_dest].reshape(G, s, K, d)
    else:
        slots = _dispatch(src, slot, E, C)

        if expert_group_linear is not None:
            count_ge = (onehot * keep[..., None].long()).sum(dim=1)  # (G, E)
            row_live = (torch.arange(C, device=dev)[None, None, :]
                        < count_ge.T[:, :, None])            # (E, G, C)
            row_live = row_live.reshape(E, G * C)
            xs = slots.permute(1, 0, 2, 3).reshape(E, G * C, d)
            up = expert_group_linear("up", xs, params["up"].to(dtype),
                                     row_live)
            if spec.gated:
                g = activation(spec.act, expert_group_linear(
                    "gate", xs, params["gate"].to(dtype), row_live))
                h = g * up
            else:
                h = activation(spec.act, up)
            out = expert_group_linear("down", h, params["down"].to(dtype),
                                      row_live)
            out_slots = out.reshape(E, G, C, d).permute(1, 0, 2, 3)
        elif expert_linear is None:
            tap("moe_in", slots, channel_axes=(1, 3), expert_first=True)
            up = torch.einsum("gecd,edf->gecf", slots,
                              params["up"].to(dtype))
            if spec.gated:
                g = activation(spec.act, torch.einsum(
                    "gecd,edf->gecf", slots, params["gate"].to(dtype)))
                h = g * up
            else:
                h = activation(spec.act, up)
            tap("moe_down", h, channel_axes=(1, 3), expert_first=True)
            out_slots = torch.einsum("gecf,efd->gecd", h,
                                     params["down"].to(dtype))
        else:
            outs = []
            for e in range(E):
                xe = slots[:, e].reshape(G * C, d)
                up = expert_linear("up", e, xe, params["up"][e].to(dtype))
                if spec.gated:
                    g = activation(spec.act, expert_linear(
                        "gate", e, xe, params["gate"][e].to(dtype)))
                    h = g * up
                else:
                    h = activation(spec.act, up)
                out = expert_linear("down", e, h,
                                    params["down"][e].to(dtype))
                outs.append(out.reshape(G, C, d))
            out_slots = torch.stack(outs, dim=1)

        gathered = _gather_slots(out_slots, slot).reshape(G, s, K, d)
    y = torch.einsum("gskd,gsk->gsd", gathered, gate_vals.to(dtype))
    return _add_shared(params, spec, xg, y).reshape(B, S, d), aux


def _route(xg: torch.Tensor, router: torch.Tensor, spec: MoESpec,
           C: int) -> tuple:
    """Top-k routing of each group's tokens ``xg`` (G, s, d) and their
    capacity slots. Returns ``(probs (G, s, E) f32, expert_ids, gate_vals
    (G, s, K), flat_ids, onehot, pos, keep, slot (G, s*K))``: ``slot`` is
    each assignment's row of the (E*C + 1)-row slot buffer, the last
    (dump) row for a capacity drop."""
    E, K = spec.n_experts, spec.top_k
    G, s = xg.shape[:2]
    logits = (xg @ router).float()
    probs = torch.softmax(logits, dim=-1)                    # (G, s, E)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1)     # (G, s, K)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # position of each (token, k) assignment within its expert, per group
    flat_ids = expert_ids.reshape(G, s * K)
    onehot = F.one_hot(flat_ids, E)                          # (G, sK, E)
    pos = (torch.cumsum(onehot, dim=1) * onehot).sum(-1) - 1  # (G, sK)
    keep = pos < C
    slot = torch.where(keep, flat_ids * C + pos,
                       torch.full_like(flat_ids, E * C))     # drop -> dump
    return probs, expert_ids, gate_vals, flat_ids, onehot, pos, keep, slot


def _dispatch(src: torch.Tensor, slot: torch.Tensor, E: int,
              C: int) -> torch.Tensor:
    """Per-group scatter of ``src`` (G, sK, d) into (G, E, C, d) capacity
    slots, through a buffer one dump row longer."""
    G, _, d = src.shape
    rows = E * C + 1
    flat_slot = (slot + torch.arange(G, device=src.device)[:, None] * rows
                 ).reshape(-1)
    buf = torch.zeros((G * rows, d), dtype=src.dtype, device=src.device)
    buf = buf.index_add_(0, flat_slot, src.reshape(-1, d))
    return buf.reshape(G, rows, d)[:, :E * C].reshape(G, E, C, d)


def _gather_slots(out_slots: torch.Tensor,
                  slot: torch.Tensor) -> torch.Tensor:
    """Each assignment's expert output (G, sK, d) from ``out_slots`` (G, E,
    C, d); dropped assignments index an appended zero row E*C."""
    G, E, C, d = out_slots.shape
    flat_out = out_slots.reshape(G, E * C, d)
    flat_out = torch.cat([flat_out, flat_out.new_zeros((G, 1, d))], dim=1)
    return flat_out[torch.arange(G, device=out_slots.device)[:, None], slot]


def _add_shared(params: dict, spec: MoESpec, xg: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """``y`` plus the shared experts' MLP of ``xg`` (G, s, d), if any."""
    if "shared" not in params:
        return y
    G, s, d = xg.shape
    shared_spec = MLPSpec(d_ff=params["shared"]["up"].shape[1],
                          act=spec.act, gated=spec.gated)
    return y + apply_mlp(params["shared"], shared_spec,
                         xg.reshape(G * s, d)).reshape(G, s, d)


def _apply_moe_sharded(params: dict, spec: MoESpec, xg: torch.Tensor,
                       C: int, shape: tuple) -> tuple:
    """``apply_moe``'s default path on DTensors: routing, dispatch and
    combine on each rank's local groups, the expert FFNs on each rank's
    slots sharded over the batch and the experts (``('batch', 'experts',
    None, None)``, as the JAX package hints them), each expert's weights
    whole on the rank that holds it. It feeds no calibration tap."""
    dtype = xg.dtype
    G, s, d = xg.shape
    E, K = spec.n_experts, spec.top_k

    def route(xg, router):
        probs, expert_ids, gate_vals, *_, slot = _route(xg, router, spec, C)
        slots = _dispatch(xg.repeat_interleave(K, dim=1), slot, E, C)
        top1 = F.one_hot(expert_ids[..., 0], E).float()
        return slots, slot, gate_vals, probs, top1
    g = ("batch", None, None)
    slots, slot, gate_vals, probs, top1 = AX.on_shards(
        route, {0: g, 1: (None, None)},
        [(g + (None,), (G, E, C, d)), (g[:2], (G, s * K)), (g, (G, s, K)),
         (g, (G, s, E)), (g, (G, s, E))],
        hint(xg, *g), params["router"].to(dtype))
    # load-balancing auxiliary loss (Switch): E * sum_e f_e * p_e
    aux = E * torch.sum(probs.mean(dim=(0, 1)) * top1.mean(dim=(0, 1)))

    def experts(slots, up_w, down_w, gate_w):
        up = torch.einsum("gecd,edf->gecf", slots, up_w)
        if gate_w is not None:
            h = activation(spec.act, torch.einsum(
                "gecd,edf->gecf", slots, gate_w)) * up
        else:
            h = activation(spec.act, up)
        return torch.einsum("gecf,efd->gecd", h, down_w)
    ge = ("batch", "experts", None, None)
    w = ("experts", None, None)
    gate_w = params["gate"].to(dtype) if spec.gated else None
    out_slots = AX.on_shards(
        experts, {0: ge, 1: w, 2: w, 3: w}, (ge, (G, E, C, d)),
        hint(slots, *ge), params["up"].to(dtype), params["down"].to(dtype),
        gate_w)

    def combine(out_slots, slot, gate_vals):
        gathered = _gather_slots(out_slots, slot)
        gathered = gathered.reshape(*gate_vals.shape, -1)
        return torch.einsum("gskd,gsk->gsd", gathered, gate_vals.to(dtype))
    y = AX.on_shards(combine, {0: g + (None,), 1: g[:2], 2: g},
                     (g, (G, s, d)), out_slots, slot, gate_vals)
    return _add_shared(params, spec, xg, y).reshape(shape), aux
