"""Gradient compression for the cross-pod all-reduce.

int8 quantise -> all-reduce -> dequantise, with per-leaf error feedback
so the quantisation error is re-injected next step (convergence-
preserving, 1-bit-Adam style residual). Meant for the slow 'pod' axis,
where the all-reduce is bound by the link between pods; the reductions
inside a pod stay f32.

The arithmetic is the JAX package's, operation by operation, in f32:
``torch.round`` rounds half to even as ``jnp.round`` does, so the
quantised payload is bitwise the same.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.common.tree import leaves, tree_map


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    amax = x.abs().max()
    return _quantize(x, amax)


def _quantize(x: torch.Tensor, amax: torch.Tensor):
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _zeros_like_tree(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)


def _unflatten(tree, values):
    """``tree``'s structure with its leaves replaced by ``values``, taken
    in ``leaves`` order (dict keys sorted)."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)
    return build(tree)


def compress_tree(grads, error_feedback: Optional[dict] = None):
    """Quantise a gradient tree, folding in the previous step's residual.
    Returns (quantised_tree, scales_tree, new_error_feedback)."""
    if error_feedback is None:
        error_feedback = _zeros_like_tree(grads)
    qs, ss, es = [], [], []
    for g, e in zip(leaves(grads), leaves(error_feedback)):
        g32 = g.float() + e
        q, s = quantize_int8(g32)
        qs.append(q)
        ss.append(s)
        es.append(g32 - dequantize_int8(q, s))
    return (_unflatten(grads, qs), _unflatten(grads, ss),
            _unflatten(grads, es))


def compressed_all_reduce(grads, mesh, axis: str,
                          error_feedback: Optional[dict] = None):
    """int8-compressed mean of each rank's ``grads`` over the ranks of
    the ``axis`` dim of ``mesh`` (a ``DeviceMesh``), on that dim's
    process group. Every rank of the group first agrees on a common
    scale (an all-reduce MAX of each leaf's amax: a scalar), then only
    the int8 payload is summed, upcast to int32 so the sum cannot
    overflow. Returns (mean_grads_f32, new_error_feedback), as the JAX
    package's ``compressed_psum`` does inside ``shard_map``."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if error_feedback is None:
        error_feedback = _zeros_like_tree(grads)
    reduced, new_e = [], []
    for g, e in zip(leaves(grads), leaves(error_feedback)):
        g32 = g.float() + e
        amax = g32.abs().max()
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        q, scale = _quantize(g32, amax)
        new_e.append(g32 - dequantize_int8(q, scale))
        total = q.to(torch.int32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        reduced.append(total.float() * scale / n)
    return _unflatten(grads, reduced), _unflatten(grads, new_e)
