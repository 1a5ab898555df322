"""The kernel ops' shared input check: no autograd, no DTensor.

A kernel's output carries no ``grad_fn``, so a launch inside a graph
that autograd records would silently cut the gradient there. A kernel
reads raw pointers of plain tensors, so a DTensor (a sharded tensor of
``torch.distributed``) must never reach one: its ``data_ptr`` is not its
local shard's. Every op under ``kernels/*/ops.py`` calls
:func:`check_inputs` first, on either device, and raises instead.
Training takes the plain paths (``models/transformer.py::forward(train=
True)``); serving and pruning run without grad; sharded callers hand the
kernels their local shards through ``local_map`` (``distributed/axes.py``).
"""
from __future__ import annotations

import torch


def check_inputs(op: str, *tensors) -> None:
    """Raise when any of ``tensors`` is a DTensor, or when grad mode is
    on and any of them requires grad."""
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{op} takes plain tensors, and an input is a DTensor: run it "
            f"on each rank's local shards through local_map "
            f"(repro_torch.distributed.axes.local_map)")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{op} has no backward pass, and an input requires grad: call "
            f"it under torch.no_grad() or on detached tensors (training "
            f"takes the plain paths: transformer.forward(train=True))")
