"""Pluggable admission-order policies for the continuous engine.

The port of ``repro/serve/policies.py``, line for line. The
:class:`~repro_torch.serve.scheduler.Scheduler` owns slots and lifecycle;
*which waiting request is admitted next* is a policy plugged in through
the same :class:`~repro_torch.core.registry.Registry` mechanism the pruning
pipeline uses for selectors/categories/stages. Registered policies:

- ``fifo`` (default) — strict arrival order, behavior-preserving with
  the pre-policy scheduler: a request that cannot be admitted (no slot,
  or the engine's resource gate says no) holds the queue head; nothing
  is reordered.
- ``priority`` — highest ``Request.priority`` first, with *aging*: each
  time a later-submitted request is popped past a waiting one, the
  waiting request's effective priority rises by ``aging`` — sustained
  high-priority load can therefore delay but never starve a
  low-priority request. Aging is bypass-counted (not wall-clock), so
  admission order is deterministic for a given workload.
- ``slo`` — earliest-deadline-first over ``Request.deadline_ms``
  (absolute deadline = arrival + deadline_ms; no deadline = +inf, FIFO
  among themselves), plus a prefill/decode interleave budget: at most
  ``prefill_budget`` chunked-prefill launches per tick while any slot
  is decoding, so long-prompt admissions cannot starve decode ticks.

All policies keep the scheduler's hold-the-head backpressure semantics:
``can_admit(head) == False`` stalls admission (in the policy's order)
rather than skipping to a smaller request — no resource-driven
reordering, so completion order stays a pure function of the policy.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Optional

from repro_torch.core.registry import Registry

SCHEDULERS = Registry("scheduler")
register_scheduler = SCHEDULERS.register


class SchedulerPolicy:
    """Admission-queue interface.

    The scheduler calls ``head(now)`` for the next candidate (or None
    when nothing has arrived), then ``pop()`` to commit the admission —
    ``pop`` always removes the request the last ``head`` returned.
    ``next_arrival()`` lets the engine sleep until work exists;
    ``prefill_budget(n_decoding)`` caps chunked-prefill launches per
    tick (None = unlimited).
    """

    def push(self, req) -> None:
        raise NotImplementedError

    def head(self, now: float):
        raise NotImplementedError

    def pop(self):
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def __bool__(self) -> bool:
        return len(self) > 0

    def next_arrival(self) -> Optional[float]:
        raise NotImplementedError

    def prefill_budget(self, n_decoding: int) -> Optional[int]:
        return None


@register_scheduler("fifo")
class FifoPolicy(SchedulerPolicy):
    """Strict arrival order."""

    def __init__(self):
        self._q: deque = deque()

    def push(self, req) -> None:
        self._q.append(req)

    def head(self, now: float):
        if self._q and self._q[0].arrival <= now:
            return self._q[0]
        return None

    def pop(self):
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def next_arrival(self) -> Optional[float]:
        return self._q[0].arrival if self._q else None


class _Entry:
    __slots__ = ("req", "seq", "age")

    def __init__(self, req, seq):
        self.req = req
        self.seq = seq
        self.age = 0


class _OrderedPolicy(SchedulerPolicy):
    """Shared machinery: linear scan over arrived entries by a key."""

    def __init__(self):
        self._waiting: list[_Entry] = []
        self._seq = 0
        self._head: Optional[_Entry] = None

    def push(self, req) -> None:
        self._waiting.append(_Entry(req, self._seq))
        self._seq += 1

    def _key(self, entry: _Entry):
        raise NotImplementedError

    def head(self, now: float):
        arrived = [e for e in self._waiting if e.req.arrival <= now]
        if not arrived:
            self._head = None
            return None
        self._head = min(arrived, key=self._key)
        return self._head.req

    def pop(self):
        entry = self._head
        assert entry is not None, "pop() without a preceding head() hit"
        self._waiting.remove(entry)
        self._head = None
        self._on_pop(entry)
        return entry.req

    def _on_pop(self, popped: _Entry) -> None:
        pass

    def __len__(self) -> int:
        return len(self._waiting)

    def next_arrival(self) -> Optional[float]:
        if not self._waiting:
            return None
        return min(e.req.arrival for e in self._waiting)


@register_scheduler("priority")
class PriorityPolicy(_OrderedPolicy):
    """Highest ``Request.priority`` first; bypass-counted aging."""

    def __init__(self, aging: float = 1.0):
        super().__init__()
        self.aging = aging

    def _effective(self, e: _Entry) -> float:
        return (e.req.priority or 0) + self.aging * e.age

    def _key(self, e: _Entry):
        # min() over (-effective priority, submission order)
        return (-self._effective(e), e.seq)

    def _on_pop(self, popped: _Entry) -> None:
        # every earlier-submitted request just bypassed ages one step
        for e in self._waiting:
            if e.seq < popped.seq:
                e.age += 1


@register_scheduler("slo")
class SLOPolicy(_OrderedPolicy):
    """Earliest absolute deadline first + prefill interleave budget."""

    def __init__(self, prefill_budget: int = 1):
        super().__init__()
        self._budget = prefill_budget

    @staticmethod
    def deadline_at(req) -> float:
        if req.deadline_ms is None:
            return math.inf
        return req.arrival + req.deadline_ms / 1e3

    def _key(self, e: _Entry):
        return (self.deadline_at(e.req), e.seq)

    def prefill_budget(self, n_decoding: int) -> Optional[int]:
        # unlimited while nothing is decoding (no one to starve)
        return self._budget if n_decoding else None


def make_policy(name: str) -> SchedulerPolicy:
    """Fresh policy instance (policies hold per-run queue state)."""
    return SCHEDULERS.get(name)()
