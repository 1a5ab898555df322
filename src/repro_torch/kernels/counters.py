"""Kernel launch counters.

Each kernel's launcher records one launch where it launches its GPU
kernel, and nowhere else: the CPU path (the plain version) records
nothing. A run resets the counts, drives the path, and reads
:func:`snapshot` to show which kernels the path went through.

A quantity that lives on the device (the MoE kernels' experts computed
per launch) is added with :func:`record_device` into a device-side
accumulator, so a launch never waits for the host; :func:`snapshot`
reads the accumulators back (one synchronising copy each).
"""
from __future__ import annotations

from collections import Counter

import torch

_LAUNCHES: Counter = Counter()
_DEVICE: dict = {}    # name -> 0-d int64 tensor on the device


def record(kernel: str, n: int = 1) -> None:
    _LAUNCHES[kernel] += n


def record_device(name: str, value: torch.Tensor) -> None:
    """Add a 0-d integer tensor to ``name``'s accumulator on its device."""
    acc = _DEVICE.get(name)
    if acc is None:
        acc = _DEVICE[name] = torch.zeros((), dtype=torch.int64,
                                          device=value.device)
    acc.add_(value.to(acc.device, torch.int64))


def reset() -> None:
    _LAUNCHES.clear()
    _DEVICE.clear()


def snapshot() -> dict:
    """{kernel or quantity name: total since the last reset}."""
    out = dict(_LAUNCHES)
    for name, acc in _DEVICE.items():
        out[name] = int(acc)
    return out
