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
each shard updates itself, and the global norm reduces over every
shard.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.common.tree import leaves, tree_map, zip_leaves
from repro_torch.distributed.axes import full

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
    return x.dim() >= 2 and x.shape[-1] >= 2 and x.shape[-2] >= 2


def init_opt(params, cfg: OptConfig) -> dict:
    """Zero moments on each leaf's device; ``step`` a 0-d int32 tensor
    on the first leaf's device."""
    m_dtype = getattr(torch, cfg.m_dtype)
    m = tree_map(lambda x: torch.zeros_like(x, dtype=m_dtype), params)
    if cfg.factored:
        def init_v(x):
            if _factorable(x):
                return {"row": torch.zeros(x.shape[:-1], dtype=F32,
                                           device=x.device),
                        "col": torch.zeros(x.shape[:-2] + x.shape[-1:],
                                           dtype=F32, device=x.device)}
            return {"full": torch.zeros_like(x, dtype=F32)}
        v = tree_map(init_v, params)
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


@torch.no_grad()
def apply_updates(params, grads, opt_state: dict, cfg: OptConfig):
    """One AdamW step, in place: the param, ``m`` and ``v`` tensors are
    overwritten (the counterpart of the JAX Trainer's donated state) and
    ``opt_state['step']`` is replaced. Returns ``(params, opt_state,
    stats)`` with the same trees; the arithmetic is the JAX package's,
    operation by operation, in f32."""
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

    for p, g, m, v in zip_leaves(params, grads, opt_state["m"],
                                 opt_state["v"]):
        g32 = g.float() * scale if scale is not None else g.float()
        m.copy_(cfg.b1 * m.float() + (1 - cfg.b1) * g32)
        if cfg.factored and _factorable(p):
            g2 = g32.square()
            row, col = v["row"], v["col"]
            row.copy_(cfg.b2 * row + (1 - cfg.b2) * g2.mean(-1))
            col.copy_(cfg.b2 * col + (1 - cfg.b2) * g2.mean(-2))
            del g2
            denom = ((row[..., :, None] * col[..., None, :])
                     / torch.clamp(row.mean(-1, keepdim=True)[..., None],
                                   min=1e-30)
                     / b2c).sqrt_().add_(cfg.eps)
        else:
            vf = v["full"] if cfg.factored else v
            vf.copy_(cfg.b2 * vf + (1 - cfg.b2) * g32.square())
            denom = (vf / b2c).sqrt_().add_(cfg.eps)
        delta = (m.float() / b1c).div_(denom)
        del denom
        p32 = p.float()
        delta.add_(cfg.weight_decay * p32)
        p.copy_(p32 - lr * delta)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
