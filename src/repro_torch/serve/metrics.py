"""Per-stage serving observability: ring-buffer series + percentiles.

The engine tick loop is the only place that sees every stage of a
request's life — queue wait, prefill, decode — and every tick-level
gauge (active slots, free blocks, prefill backlog, tokens/s). This
module gives it somewhere cheap to put those numbers: a
:class:`MetricsRegistry` of fixed-size ring buffers (latency samples),
monotonic counters, and last-value gauges, summarised on demand as one
JSON-safe dict (deepsparse's ``_TextGenerationTimings`` per-stage
timers are the model).

Pure host-side numpy, ported line for line from
``repro/serve/metrics.py`` — recording must never touch the device.

Beside the registry sits the port's span log (``common/spans.py``,
re-exported here as :data:`SPANS`): host intervals at each layer
boundary of the serving path (decode burst, tick, block, attention,
FFN, prefill chunk), off by default; a caller enables it, serves, and
drains the records (the module docstring there says how).
"""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from repro_torch.common.spans import LOG as SPANS  # noqa: F401
from repro_torch.common.spans import SpanLog  # noqa: F401

# the canonical per-request stage series, milliseconds (recorded by the
# engine for every Finished request; names are part of the wire schema)
REQUEST_STAGES = ("request.queue_ms", "request.prefill_ms",
                  "request.decode_ms", "request.total_ms")
# per-tick gauges (recorded each decode tick / loop iteration)
TICK_GAUGES = ("tick.active_slots", "tick.prefill_backlog",
               "tick.free_blocks", "tick.tokens_per_s")


class RingBuffer:
    """Fixed-capacity float samples; overwrites the oldest."""

    def __init__(self, capacity: int = 1024):
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0                     # total samples ever observed

    def add(self, value: float) -> None:
        self._buf[self._n % len(self._buf)] = value
        self._n += 1

    def values(self) -> np.ndarray:
        if self._n >= len(self._buf):
            return self._buf
        return self._buf[:self._n]

    def __len__(self) -> int:
        return min(self._n, len(self._buf))

    @property
    def total(self) -> int:
        return self._n


class MetricsRegistry:
    """Named series (ring buffers), counters, and gauges.

    ``observe`` feeds a distribution series; ``count`` bumps a
    monotonic counter; ``gauge`` records a last-value sample.
    ``summary()`` renders everything as one nested JSON-safe dict with
    percentile digests for each series.
    """

    def __init__(self, capacity: int = 1024,
                 percentiles: Iterable[int] = (50, 90, 99)):
        self.capacity = capacity
        self.pcts = tuple(percentiles)
        self.series: dict[str, RingBuffer] = {}
        self.counters: dict[str, float] = {}
        self.gauges: dict[str, float] = {}

    # ---------------------------------------------------------- record

    def observe(self, name: str, value: float) -> None:
        buf = self.series.get(name)
        if buf is None:
            buf = self.series[name] = RingBuffer(self.capacity)
        buf.add(float(value))

    def count(self, name: str, inc: float = 1.0) -> None:
        self.counters[name] = self.counters.get(name, 0.0) + inc

    def gauge(self, name: str, value: float) -> None:
        self.gauges[name] = float(value)
        self.observe(name, value)       # gauges keep a history too

    # ---------------------------------------------------------- export

    def percentiles(self, name: str,
                    p: Iterable[int] = (50, 99)) -> dict:
        buf = self.series.get(name)
        if buf is None or not len(buf):
            return {f"p{q}": 0.0 for q in p}
        vals = buf.values()
        return {f"p{q}": float(np.percentile(vals, q)) for q in p}

    def summary(self) -> dict:
        """JSON-safe digest of every series/counter/gauge."""
        out: dict = {"series": {}, "counters": dict(self.counters),
                     "gauges": dict(self.gauges)}
        for name, buf in sorted(self.series.items()):
            vals = buf.values()
            digest = {"count": int(buf.total)}
            if len(vals):
                digest.update({
                    "mean": float(np.mean(vals)),
                    "min": float(np.min(vals)),
                    "max": float(np.max(vals)),
                })
                digest.update({f"p{q}": float(np.percentile(vals, q))
                               for q in self.pcts})
            out["series"][name] = digest
        return out

    def reset(self) -> None:
        self.series.clear()
        self.counters.clear()
        self.gauges.clear()


# --------------------------------------------------------- request stages

def stage_latencies_ms(finished) -> dict:
    """Per-stage latencies of one ``scheduler.Finished`` record, ms.

    queue   = arrival -> admission (slot + blocks granted)
    prefill = admission -> first sampled token
    decode  = first token -> finish
    total   = arrival -> finish
    """
    req = finished.request
    return {
        "queue_ms": (finished.admitted_at - req.arrival) * 1e3,
        "prefill_ms": (finished.first_token_at
                       - finished.admitted_at) * 1e3,
        "decode_ms": (finished.finished_at
                      - finished.first_token_at) * 1e3,
        "total_ms": (finished.finished_at - req.arrival) * 1e3,
    }


def observe_finished(metrics: Optional[MetricsRegistry], finished) -> None:
    """Record one finished request's stage latencies into ``metrics``."""
    if metrics is None:
        return
    stages = stage_latencies_ms(finished)
    for key, value in stages.items():
        metrics.observe(f"request.{key}", value)
    metrics.count("requests.finished")
    metrics.count(f"requests.finish_reason.{finished.reason}")


def latency_percentiles(finished: list, p=(50, 99)) -> dict:
    """Request-completion latency (arrival -> finish) percentiles, ms.

    The metrics layer owns every latency digest.
    """
    lats = [(f.finished_at - f.request.arrival) * 1e3 for f in finished]
    if not lats:
        return {f"p{q}": 0.0 for q in p}
    return {f"p{q}": float(np.percentile(lats, q)) for q in p}


def queue_percentiles(finished: list, p=(50, 99)) -> dict:
    """Queue-wait (arrival -> admission) percentiles, ms."""
    lats = [(f.admitted_at - f.request.arrival) * 1e3 for f in finished]
    if not lats:
        return {f"p{q}": 0.0 for q in p}
    return {f"p{q}": float(np.percentile(lats, q)) for q in p}


def slo_attainment(finished: list) -> float:
    """Fraction of deadline-carrying requests that finished within
    ``request.deadline_ms`` of arrival. 1.0 when none carry deadlines."""
    dl = [f for f in finished if f.request.deadline_ms is not None]
    if not dl:
        return 1.0
    met = sum(1 for f in dl
              if (f.finished_at - f.request.arrival) * 1e3
              <= f.request.deadline_ms)
    return met / len(dl)
