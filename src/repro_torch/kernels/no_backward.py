"""The kernels have no backward pass: their ops refuse autograd inputs.

A kernel's output carries no ``grad_fn``, so a launch inside a graph
that autograd records would silently cut the gradient there. Every op
under ``kernels/*/ops.py`` calls :func:`refuse_grad` first, on either
device, and raises instead. Training takes the plain paths
(``models/transformer.py::forward(train=True)``); serving and pruning
run without grad.
"""
from __future__ import annotations

import torch


def refuse_grad(op: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward pass, and an input requires grad: call "
            f"it under torch.no_grad() or on detached tensors (training "
            f"takes the plain paths: transformer.forward(train=True))")
