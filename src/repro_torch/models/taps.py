"""Activation taps: capture the per-input-channel sum of squares at every
projection input during a forward pass (the ``||A||_2`` term of Eq. 5).

Layer functions call :func:`tap`; a collector is active only inside
``collecting()``, which yields the list of ``(name, stat)`` pairs in the
order the forward emitted them. Only the ``ssq`` mode is ported; the
Gram (``hessian`` / ``both``) modes come with the sparsegpt selector.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_COLLECTOR: Optional[list] = None


def tap(name: str, x: torch.Tensor, channel_axes=(-1,),
        expert_first: bool = False) -> None:
    """Record the per-channel sum of squares of ``x`` over all axes but
    ``channel_axes`` (the projection's input-feature axes). With
    ``expert_first`` the first kept axis is the expert axis of an MoE
    slot tensor (per-expert statistics); the sums are the same, the flag
    matters only to the Gram modes, which are not ported."""
    if _COLLECTOR is None:
        return
    keep = sorted(a % x.dim() for a in channel_axes)
    reduce_axes = tuple(a for a in range(x.dim()) if a not in keep)
    _COLLECTOR.append((name, x.float().square().sum(dim=reduce_axes)))


@contextlib.contextmanager
def collecting(mode: str = "ssq"):
    global _COLLECTOR
    if mode != "ssq":
        raise NotImplementedError(
            f"tap mode {mode!r} is not ported yet (only 'ssq')")
    prev = _COLLECTOR
    _COLLECTOR = []
    try:
        yield _COLLECTOR
    finally:
        _COLLECTOR = prev
