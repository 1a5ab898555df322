"""Param exchange with the JAX package through numpy.

``params_from_numpy`` takes the JAX params as numpy arrays (from
``jax.tree_util.tree_map(np.asarray, params)``) and returns the port's
tensor tree with the same structure and layout; ``params_to_numpy``
goes the other way. bf16 leaves travel as ``ml_dtypes.bfloat16`` on the
numpy side, which torch cannot wrap directly, so they pass through f32
(exact: every bf16 value is an f32 value).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import Tree, tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def params_from_numpy(tree: Tree, device) -> Tree:
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(tree: Tree) -> Tree:
    """Tensors to numpy arrays (bf16 leaves come back as f32)."""
    def one(t: torch.Tensor) -> np.ndarray:
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()
    return tree_map(one, tree)


# ------------------------------------------------- scanned <-> unrolled
# A scanned config (``scan_layers=True``) stores ``params['blocks']`` in
# the JAX package as one tree per pattern slot whose leaves carry a
# leading ``n_periods`` axis; the port runs unrolled stacks, one tree per
# layer. Layer ``i`` is slot ``i % P``, period ``i // P`` (P the pattern
# length). The optimizer moments mirror the params, so the same pair
# converts them.

def unstack_blocks(slots, n_periods: int) -> list:
    """Scanned blocks (a tuple of P slot trees, leaves (n_periods, ...))
    -> the unrolled list of ``P * n_periods`` layer trees (views)."""
    P = len(slots)
    return [tree_map(lambda x, t=i // P: x[t], slots[i % P])
            for i in range(P * n_periods)]


def stack_blocks(blocks: list, period: int) -> tuple:
    """The unrolled list of layer trees -> scanned blocks: a tuple of
    ``period`` slot trees whose leaves stack the slot's layers along a new
    leading axis (meta leaves stack to meta leaves)."""
    n_periods = len(blocks) // period
    out = []
    for j in range(period):
        layers = [blocks[t * period + j] for t in range(n_periods)]
        out.append(_stack_trees(layers))
    return tuple(out)


def _stack_trees(trees: list):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(trees)
