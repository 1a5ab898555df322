"""Plain PyTorch version of the paged step's prologue: RoPE of q and k
from per-position cos/sin tables, then k and v scattered into the paged
arenas at given arena rows. The arithmetic is the eager model code's
(``models/layers.py::_rope`` calls :func:`rope_rotate`, and
``paged_write`` scatters the same way)."""
from __future__ import annotations

from typing import Optional

import torch


def rope_rotate(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D) rotated by tables (B, S, D / 2) of f32: each
    product and sum in f32, rounded once to x's dtype."""
    half = x.shape[-1] // 2
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def rope_kv_write_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_arena: torch.Tensor, v_arena: torch.Tensor,
                      rows: torch.Tensor, cos: Optional[torch.Tensor] = None,
                      sin: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, S, n_q, D), k, v (B, S, n_kv, D); arenas (n_blocks + 1, bs,
    n_kv, D); rows (B, S) arena rows; cos, sin (B, S, D / 2) or None (no
    RoPE). Rotates q in place, writes rotated k and v into the arenas in
    place, and returns q."""
    if cos is not None:
        q.copy_(rope_rotate(q, cos, sin))
        k = rope_rotate(k, cos, sin)
    flat_rows = rows.reshape(-1)
    for arena, new in ((k_arena, k), (v_arena, v)):
        flat = arena.view(-1, *arena.shape[2:])
        flat[flat_rows] = new.to(flat.dtype).reshape(-1, *new.shape[2:])
    return q
