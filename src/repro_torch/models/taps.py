"""Activation taps: capture a statistic of every projection input during
a forward pass: the per-input-channel sum of squares (the ``||A||_2``
term of Eq. 5) or the Gram matrix ``X^T X`` (the SparseGPT Hessian).

Layer functions call :func:`tap`; a collector is active only inside
``collecting()``, which yields the list of ``(name, stat)`` pairs in the
order the forward emitted them. Statistics accumulate in f32.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_COLLECTOR: Optional[list] = None
_MODE: str = "ssq"


def _ssq_stat(x32: torch.Tensor, reduce_axes: tuple) -> torch.Tensor:
    return x32.square().sum(dim=reduce_axes)


def _gram_stat(x32: torch.Tensor, keep: list,
               expert_first: bool) -> torch.Tensor:
    """X^T X over the flattened kept axes; with ``expert_first`` the first
    kept axis is the expert axis and the result is (E, d, d)."""
    dims = 1
    if expert_first:
        xe = x32.movedim(keep[0], 0)
        for a in keep[1:]:
            dims *= x32.shape[a]
        flat = xe.reshape(xe.shape[0], -1, dims)
        return flat.mT @ flat
    for a in keep:
        dims *= x32.shape[a]
    flat = x32.reshape(-1, dims)
    return flat.T @ flat


def tap(name: str, x: torch.Tensor, channel_axes=(-1,),
        expert_first: bool = False) -> None:
    """Record a statistic of ``x`` over all axes but ``channel_axes`` (the
    projection's input-feature axes, which must be the trailing ones
    unless ``expert_first``).

    mode 'ssq': per-channel sum of squares (-> ||A||_2 for Eq. 5).
    mode 'hessian': X^T X over the flattened channel axes (SparseGPT).
    mode 'both': the (ssq, X^T X) pair from one forward pass.
    ``expert_first``: the first channel axis is the expert axis of an MoE
    slot tensor (per-expert statistics), not a feature axis.
    """
    if _COLLECTOR is None:
        return
    keep = sorted(a % x.dim() for a in channel_axes)
    reduce_axes = tuple(a for a in range(x.dim()) if a not in keep)
    x32 = x.float()
    if _MODE == "ssq":
        stat = _ssq_stat(x32, reduce_axes)
    elif _MODE == "hessian":
        stat = _gram_stat(x32, keep, expert_first)
    elif _MODE == "both":
        stat = (_ssq_stat(x32, reduce_axes),
                _gram_stat(x32, keep, expert_first))
    else:
        raise ValueError(f"unknown tap mode {_MODE!r}")
    _COLLECTOR.append((name, stat))


@contextlib.contextmanager
def collecting(mode: str = "ssq"):
    global _COLLECTOR, _MODE
    prev, prev_mode = _COLLECTOR, _MODE
    _COLLECTOR, _MODE = [], mode
    try:
        yield _COLLECTOR
    finally:
        _COLLECTOR, _MODE = prev, prev_mode
