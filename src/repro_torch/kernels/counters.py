"""Kernel launch counters.

Each kernel's launcher records one launch where it launches its GPU
kernel, and nowhere else: the CPU path (the plain version) records
nothing. A run resets the counts, drives the path, and reads
:func:`snapshot` to show which kernels the path went through.
"""
from __future__ import annotations

from collections import Counter

_LAUNCHES: Counter = Counter()


def record(kernel: str, n: int = 1) -> None:
    _LAUNCHES[kernel] += n


def reset() -> None:
    _LAUNCHES.clear()


def snapshot() -> dict:
    """{kernel name: launches since the last reset}."""
    return dict(_LAUNCHES)
