"""Fault tolerance: preemption handling, straggler detection, retries.

On a cluster these hooks fire from the scheduler (SIGTERM before
preemption) and from per-host step timing; on one host they are fully
implemented and tested. Nothing here touches the card.
"""
from __future__ import annotations

import signal
import threading
import time
from typing import Callable, Optional


class PreemptionHandler:
    """Installs a SIGTERM watcher; the train loop polls ``should_stop``
    and checkpoints before it exits."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._stop = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for sig in self._signals:
            self._prev[sig] = signal.signal(sig, self._handler)
        return self

    def _handler(self, signum, frame):
        self._stop.set()

    def trigger(self) -> None:
        """Ask for a stop as the signal would (tests, manual drains)."""
        self._stop.set()

    @property
    def should_stop(self) -> bool:
        return self._stop.is_set()

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        self._prev.clear()


class StragglerMonitor:
    """EMA-based step-time watermark. A step slower than ``threshold x
    EMA`` is flagged and leaves the EMA as it was, so one slow step does
    not raise the watermark."""

    def __init__(self, threshold: float = 2.0, ema: float = 0.9,
                 warmup: int = 5):
        self.threshold = threshold
        self.ema_factor = ema
        self.warmup = warmup
        self.ema: Optional[float] = None
        self.count = 0
        self.flagged: list = []

    def record(self, step: int, seconds: float) -> bool:
        self.count += 1
        is_straggler = False
        if self.ema is not None and self.count > self.warmup:
            if seconds > self.threshold * self.ema:
                self.flagged.append((step, seconds, self.ema))
                is_straggler = True
        if self.ema is None:
            self.ema = seconds
        elif not is_straggler:
            self.ema = (self.ema_factor * self.ema
                        + (1 - self.ema_factor) * seconds)
        return is_straggler


def with_retries(fn: Callable, n_retries: int = 3, backoff: float = 0.1,
                 exceptions=(Exception,)):
    """Retry wrapper for flaky IO (data shards, checkpoint storage), with
    exponential backoff; the last failure is raised."""
    def wrapped(*args, **kwargs):
        for attempt in range(n_retries + 1):
            try:
                return fn(*args, **kwargs)
            except exceptions:
                if attempt == n_retries:
                    raise
                time.sleep(backoff * (2 ** attempt))
    return wrapped
