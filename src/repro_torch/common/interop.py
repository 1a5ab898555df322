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
