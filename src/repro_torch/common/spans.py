"""The serving path's span log: where the host's time goes, call by call.

A span is one interval of host time at a layer boundary (a decode burst,
one tick, one block's attention): its name, its start and end on
``time.perf_counter_ns()``, the index of the span open around it (its
parent, -1 at the top) and a few integer attributes (a layer index, a
request uid). The engine (``serve/batching.py``), the forward
(``models/transformer.py``) and the FFN hook (``serve/sparse.py``)
record into the one process-level :data:`LOG`, as the kernels record
into ``kernels/counters.py``; ``serve/metrics.py`` re-exports it beside
the :class:`~repro_torch.serve.metrics.MetricsRegistry`.

The log is off by default and costs a span site one flag test then: no
clock is read, nothing is allocated and the device is never touched. A
caller turns it on with :meth:`SpanLog.enable`, off with
:meth:`SpanLog.disable`, and takes the records with
:meth:`SpanLog.drain`. Spans are recorded from one thread at a time
(the engine's): the parent of a span is the innermost span open when it
opened. Recording never adds, reorders or synchronises device work, so
the served tokens are those of a run with the log off.

To look at a stretch of serving, enable the log around it and drain the
records between calls, from the engine's thread or while it is idle::

    from repro_torch.serve.metrics import SPANS
    SPANS.enable()
    finished, stats = engine.run(requests)    # or a stretch of serve_forever
    SPANS.disable()
    for name, t0_ns, t1_ns, parent, attrs in SPANS.drain():
        ...                                   # parent: index into the list

No ``ServeConfig`` field or environment variable turns it on. The spans
(children indented):

- ``decode_burst`` (``rows`` active slots, ``ticks``, ``slots``)
  - ``burst.prep``: the host arrays and their copies to the device
  - ``tick``, once a tick: ``embed``, ``block`` (``layer``) each with
    ``attn`` (``mamba`` for an SSM mixer) and ``ffn``, ``head``, then
    ``sample``
  - ``burst.sync``: the burst's one copy back
  - ``burst.commit``: the scheduler's bookkeeping and the registry's
    updates
- ``prefill_chunk`` (``uid``, ``start``, ``n``; the contiguous pool's
  whole prompt is one chunk): ``chunk.prep``, ``embed``, the ``block``
  spans, ``head``, and on a prompt's last chunk ``sample_first`` (its sync)
- ``admit``, ``cow_guard``: the paged loop's admission and copy-on-write
  passes

``ffn`` is recorded by the block-sparse FFN hook (``serve/sparse.py``),
so a model served without plans has blocks with ``attn`` alone. A log
holds :data:`CAPACITY` spans between drains; ``dropped`` counts the
spans past that.

A site reads::

    k = LOG.open("tick") if LOG.on else -1
    ...
    if k >= 0:
        LOG.close(k)
"""
from __future__ import annotations

import time

CAPACITY = 1 << 17          # spans a log holds between drains


class SpanLog:
    """Span records, allocated at the first enable and reused across
    enables: a log never enabled holds nothing (nothing for the
    collector to walk in a process that never traces)."""

    def __init__(self, capacity: int = CAPACITY):
        self.on = False
        self.capacity = capacity
        self._name: list = []
        self._stack: list = []
        self.n = 0
        self.dropped = 0        # spans not recorded: the log was full

    def enable(self) -> None:
        """Start recording into an empty log."""
        if not self._name:
            c = self.capacity
            self._name, self._t0, self._t1 = [""] * c, [0] * c, [0] * c
            self._parent, self._attrs = [-1] * c, [None] * c
        self.n = self.dropped = 0
        self._stack.clear()
        self.on = True

    def disable(self) -> None:
        """Stop recording. Spans still open close as usual."""
        self.on = False

    def open(self, name: str, **attrs) -> int:
        """Record the start of span ``name``; returns its index, -1 when
        the log is full."""
        k = self.n
        if k >= self.capacity:
            self.dropped += 1
            return -1
        self.n = k + 1
        self._name[k] = name
        self._parent[k] = self._stack[-1] if self._stack else -1
        self._attrs[k] = attrs or None
        self._t1[k] = 0
        self._stack.append(k)
        self._t0[k] = time.perf_counter_ns()
        return k

    def close(self, k: int) -> None:
        """Record the end of span ``k`` (and of any child left open)."""
        t = time.perf_counter_ns()
        self._t1[k] = t
        stack = self._stack
        while stack:
            top = stack.pop()
            if top == k:
                break
            self._t1[top] = t

    def drain(self) -> list:
        """The records since the last enable or drain, as ``(name,
        t0_ns, t1_ns, parent, attrs)`` tuples indexed as their parents
        are; empties the log. Call it with no span open."""
        if self._stack:
            raise RuntimeError(f"{len(self._stack)} span(s) still open")
        out = [(self._name[k], self._t0[k], self._t1[k], self._parent[k],
                self._attrs[k] or {}) for k in range(self.n)]
        self.n = 0
        return out


LOG = SpanLog()
