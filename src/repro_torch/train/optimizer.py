"""AdamW, written out (no ``torch.optim``), as the JAX package writes it:

  - a linear-warmup + cosine-decay schedule;
  - global-norm gradient clipping;
  - an optional factored second moment (Adafactor-style) for >= 2-D
    leaves, so the optimizer state of a very large model fits;
  - the first moment in ``m_dtype`` (bf16 halves its memory).

The state is a nested dict of tensors whose paths are the JAX package's
(``m``, ``v``, ``step``; a factored ``v`` leaf is ``{row, col}`` or
``{full}``), so a training checkpoint restores in either package.
Every scalar (learning rate, bias corrections) stays a 0-d tensor on the
params' device: a step never waits for the host. The params may be
DTensors (``distributed/sharding.py``): the update is elementwise, so
each shard updates itself, the global norm reduces over every shard,
and a factored ``v`` is laid out by ``sharding.v_spec`` with its row
and column means reduced across the shards.

A scanned config trains unrolled, but JAX factors each period-stacked
leaf as a whole: a per-layer vector's stack ``(n_periods, d)`` gets a
``row`` over the periods and a ``col`` over ``d`` that the layers
share. ``init_opt(..., period=P)`` keeps such a factored ``v``'s
blocks in JAX's scanned layout (P slot trees of stacked leaves), and
``apply_updates`` updates it from the unrolled params and gradients.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.tree import leaves, tree_map, zip_leaves
from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import full
from repro_torch.distributed.sharding import factorable, v_spec

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    factored: bool = False       # factored v for >= 2-D leaves
    m_dtype: str = "float32"     # "bfloat16" halves the momentum memory


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a 0-d integer tensor), in f32."""
    step = torch.as_tensor(step).to(F32)
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def _factorable(x: torch.Tensor) -> bool:
    return factorable(x.shape)


def _factored_zeros(x: torch.Tensor, n_periods=None) -> dict:
    """A zero factored second moment for leaf ``x``, or for
    ``n_periods`` such leaves stacked on a new leading axis; laid out
    by ``v_spec`` on ``x``'s mesh when ``x`` is a DTensor."""
    lead = () if n_periods is None else (n_periods,)
    shape = lead + tuple(x.shape)
    shapes = v_spec(shape, shape)
    if not AX.is_dtensor(x):
        return {k: torch.zeros(s, dtype=F32, device=x.device)
                for k, s in shapes.items()}
    from torch.distributed.tensor import zeros
    mesh = x.device_mesh
    specs = v_spec(shape, (None,) * len(lead) + AX.placements_spec(x))
    return {k: zeros(s, dtype=F32, device_mesh=mesh,
                     placements=AX.spec_placements(mesh, specs[k]))
            for k, s in shapes.items()}


def init_opt(params, cfg: OptConfig, period=None) -> dict:
    """Zero moments on each leaf's device (DTensors laid out as the
    params, a factored ``v`` by ``sharding.v_spec``); ``step`` a 0-d
    int32 tensor on the first leaf's device. ``period`` (a scanned
    config's pattern length; ``params['blocks']`` its unrolled layers)
    puts a factored ``v``'s blocks in JAX's scanned layout."""
    m_dtype = getattr(torch, cfg.m_dtype)
    m = tree_map(lambda x: torch.zeros_like(x, dtype=m_dtype), params)
    if cfg.factored:
        v = tree_map(_factored_zeros, params)
        if period is not None:
            blocks = params["blocks"]
            n = len(blocks) // period
            v["blocks"] = tuple(
                tree_map(lambda x: _factored_zeros(x, n), blocks[j])
                for j in range(period))
    else:
        v = tree_map(lambda x: torch.zeros_like(x, dtype=F32), params)
    device = next(leaves(params)).device
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(tree) -> torch.Tensor:
    """A plain 0-d tensor: a DTensor leaf's square sum is reduced over
    every shard (a collective: every rank must call it)."""
    sq = [full(x.float().square().sum()) for x in leaves(tree)]
    return torch.stack(sq).sum().sqrt()


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads in f32 scaled to a global norm of at most ``max_norm``, the
    norm before scaling). f32 whatever the grads' dtype, as the JAX
    package's product with its f32 scale is."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gnorm


def _mean(x: torch.Tensor, dim: int, keepdim: bool = False) -> torch.Tensor:
    """``x.mean(dim)``. On a DTensor: the local sums, summed across the
    mesh axes that shard ``dim``, over the global length; laid out as
    ``x`` without ``dim`` (or with it whole), no partial sum left."""
    if not AX.is_dtensor(x):
        return x.mean(dim, keepdim=keepdim)
    from torch.distributed.tensor import Replicate, Shard
    dim %= x.dim()
    placements = [Replicate() if p.is_shard(dim) else
                  Shard(p.dim - 1) if p.is_shard() and p.dim > dim
                  and not keepdim else p for p in x.placements]
    total = x.sum(dim, keepdim=keepdim).redistribute(x.device_mesh,
                                                      placements)
    return total / x.shape[dim]


def _assign(dst: torch.Tensor, value: torch.Tensor) -> None:
    """``dst.copy_(value)``, a DTensor ``value`` laid out as ``dst``
    first."""
    if AX.is_dtensor(value) and value.placements != dst.placements:
        value = value.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(value)


def _factored_denom(row, col, b2c, eps: float) -> torch.Tensor:
    return ((row[..., :, None] * col[..., None, :])
            / torch.clamp(_mean(row, -1, keepdim=True)[..., None], min=1e-30)
            / b2c).sqrt_().add_(eps)


def _second_moment(v, g32: torch.Tensor, cfg: OptConfig, b2c) -> torch.Tensor:
    """``v`` (a tensor, or a factored ``{row, col}`` or ``{full}``)
    updated in place from the f32 gradient ``g32``; returns the step's
    denominator."""
    g2 = g32.square()
    if isinstance(v, dict) and "row" in v:
        row, col = v["row"], v["col"]
        _assign(row, cfg.b2 * row + (1 - cfg.b2) * _mean(g2, -1))
        _assign(col, cfg.b2 * col + (1 - cfg.b2) * _mean(g2, -2))
        del g2
        return _factored_denom(row, col, b2c, cfg.eps)
    vf = v["full"] if isinstance(v, dict) else v
    vf.copy_(cfg.b2 * vf + (1 - cfg.b2) * g2)
    del g2
    return (vf / b2c).sqrt_().add_(cfg.eps)


def _without_blocks(tree: dict) -> dict:
    return {k: x for k, x in tree.items() if k != "blocks"}


@torch.no_grad()
def apply_updates(params, grads, opt_state: dict, cfg: OptConfig):
    """One AdamW step, in place: the param, ``m`` and ``v`` tensors are
    overwritten (the counterpart of the JAX Trainer's donated state) and
    ``opt_state['step']`` is replaced. Returns ``(params, opt_state,
    stats)`` with the same trees; the arithmetic is the JAX package's,
    operation by operation, in f32. A factored ``v`` whose blocks are in
    the scanned layout (``init_opt(..., period=P)``) is updated as JAX
    updates the stacked leaves."""
    step = opt_state["step"] + 1
    lr = schedule(cfg, step)
    gnorm = global_norm(grads)
    # clipping scales each leaf inside the loop, so the clipped grads
    # never exist all at once
    scale = _clip_scale(gnorm, cfg.clip_norm) if cfg.clip_norm else None
    step_f = step.to(F32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32,
                                     device=step.device), step_f)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32,
                                     device=step.device), step_f)

    def first_moment(g, m):
        """``m`` updated in place; returns the clipped f32 gradient."""
        g32 = g.float() * scale if scale is not None else g.float()
        m.copy_(cfg.b1 * m.float() + (1 - cfg.b1) * g32)
        return g32

    def update_param(p, m, denom):
        """``p`` stepped in place (pass ``denom`` inline: it is freed
        here)."""
        delta = (m.float() / b1c).div_(denom)
        del denom
        p32 = p.float()
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)

    trees = (params, grads, opt_state["m"], opt_state["v"])
    stacked = cfg.factored and isinstance(opt_state["v"].get("blocks"),
                                          tuple)
    for p, g, m, v in zip_leaves(*(map(_without_blocks, trees) if stacked
                                   else trees)):
        update_param(p, m, _second_moment(v, first_moment(g, m), cfg, b2c))
    if stacked:
        _update_stacked(*(t["blocks"] for t in trees), cfg, b2c,
                        first_moment, update_param)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}


def _update_stacked(pb: list, gb: list, mb: list, vb: tuple,
                    cfg: OptConfig, b2c, first_moment, update_param):
    """The blocks' update against a scanned factored ``v`` (``vb``: P
    slot trees whose leaves stack layers ``j, j + P, ...``), as JAX
    updates each stacked leaf. A leaf factorable per layer keeps its
    per-layer arithmetic (only its factors are stacked); any other
    (a per-layer vector, whose stack factors across the layers) is
    stacked whole, as its gradients are small."""
    P = len(vb)
    n = len(pb) // P
    for j in range(P):
        layers = [t * P + j for t in range(n)]
        for leaf in zip_leaves(pb[j], *(pb[i] for i in layers[1:]),
                               *(gb[i] for i in layers),
                               *(mb[i] for i in layers), vb[j]):
            ps, gs, ms, v = (leaf[:n], leaf[n:2 * n], leaf[2 * n:3 * n],
                             leaf[3 * n])
            g32s = (first_moment(g, m) for g, m in zip(gs, ms))
            if not _factorable(ps[0]):
                denom = _second_moment(v, torch.stack(list(g32s)), cfg, b2c)
                for t in range(n):
                    update_param(ps[t], ms[t], denom[t])
                continue
            means = [(_mean(g2, -1), _mean(g2, -2))
                     for g2 in (g32.square() for g32 in g32s)]
            row, col = v["row"], v["col"]
            _assign(row, cfg.b2 * row
                    + (1 - cfg.b2) * torch.stack([r for r, _ in means]))
            _assign(col, cfg.b2 * col
                    + (1 - cfg.b2) * torch.stack([c for _, c in means]))
            del means
            for t in range(n):
                update_param(ps[t], ms[t], _factored_denom(
                    row[t], col[t], b2c, cfg.eps))
