"""Request scheduler for the continuous-batching engine.

Admission into a fixed pool of KV-cache slots: a request waits in the
arrival queue until a slot frees (and, on the paged pool, until the
block allocator can cover it — admission backpressure), moves to the
``prefilling`` state while its prompt enters the cache (possibly one
chunk per tick, interleaved with decode), then decodes one token per
engine tick alongside every other active slot. Finished sequences
(EOS / per-request token budget / cache full) release their slot
immediately, so requests of different lengths flow through the batch
without ever recompiling the decode step.

*Which* waiting request is admitted next is a pluggable
:class:`~repro_torch.serve.policies.SchedulerPolicy` (``fifo`` default —
strict arrival order — plus ``priority`` and ``slo``);
the scheduler owns slots and lifecycle, the policy owns queue order.
Rejections are first-class: every dropped request becomes a
:class:`Rejection` with a structured reason instead of a bare entry in
a list nothing reads.

Pure host-side bookkeeping, ported line for line from
``repro/serve/scheduler.py``: no torch in this module. The engine
(``repro_torch.serve.batching``) owns the device tensors and calls
``admissions`` / ``started`` / ``decoded`` around its steps. The
optional ``on_token`` / ``on_finish`` / ``on_reject`` callbacks fire
from those same host-side calls.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.serve.policies import SchedulerPolicy, make_policy


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` is seconds on the engine's
    workload clock (0 = available immediately).

    ``prefix_id`` is deepsparse-session-style cache identity: requests
    sharing a ``prefix_id`` (and the prompt tokens under it) share the
    prompt prefix's KV blocks on the paged pool. Sampling knobs ride on
    the request — ``temperature``/``seed`` of ``None`` fall back to the
    engine-run defaults — so mixed-temperature batches decode in one
    jitted step. ``priority`` (higher = sooner) and ``deadline_ms``
    (latency SLO relative to arrival) only matter under the
    ``priority`` / ``slo`` scheduler policies; ``fifo`` ignores both.
    """
    uid: int
    prompt: list
    max_new_tokens: int
    eos_id: Optional[int] = None
    arrival: float = 0.0
    prefix_id: Optional[str] = None
    temperature: Optional[float] = None
    seed: Optional[int] = None
    priority: int = 0
    deadline_ms: Optional[float] = None


@dataclasses.dataclass
class Slot:
    """An active sequence bound to a KV-pool slot."""
    index: int
    request: Request
    length: int = 0             # tokens currently in the slot's cache
    last_token: int = 0         # next decode input (last sampled token)
    generated: list = dataclasses.field(default_factory=list)
    admitted_at: float = 0.0
    first_token_at: float = 0.0
    prefilled: int = 0          # prompt tokens already in the cache
    #                             (starts > 0 on a shared prefix)
    shared_blocks: int = 0      # prompt blocks mapped from a prefix hit


@dataclasses.dataclass
class Finished:
    request: Request
    tokens: list                # generated tokens (includes EOS if hit)
    reason: str                 # "eos" | "length" | "cache_full"
    admitted_at: float
    first_token_at: float
    finished_at: float
    prompt_blocks_shared: int = 0   # paged: prefix-cache block hits


@dataclasses.dataclass
class Rejection:
    """A dropped request plus the structured reason it was dropped."""
    request: Request
    reason: str     # "prompt_too_long" | "insufficient_blocks"
    at: float = 0.0


class Scheduler:
    def __init__(self, max_slots: int, max_seq: int,
                 policy: Optional[SchedulerPolicy | str] = None,
                 on_token: Optional[Callable] = None,
                 on_finish: Optional[Callable] = None,
                 on_reject: Optional[Callable] = None):
        self.max_slots = max_slots
        self.max_seq = max_seq
        if policy is None or isinstance(policy, str):
            policy = make_policy(policy or "fifo")
        self.policy = policy
        self.prefilling: dict[int, Slot] = {}       # index -> admitted slot
        self.slots: dict[int, Slot] = {}            # index -> decoding slot
        self.free: list[int] = list(range(max_slots - 1, -1, -1))
        self.finished: list[Finished] = []
        self.rejected: list[Rejection] = []
        self.on_token = on_token        # (slot, token, now)
        self.on_finish = on_finish      # (Finished)
        self.on_reject = on_reject      # (Rejection)

    # ------------------------------------------------------------ intake

    def submit(self, request: Request) -> None:
        if len(request.prompt) + 1 > self.max_seq:
            # can't fit prompt + one generated token
            self.reject(request, "prompt_too_long", request.arrival)
        else:
            self.policy.push(request)

    def reject(self, request: Request, reason: str,
               now: float = 0.0) -> None:
        rej = Rejection(request=request, reason=reason, at=now)
        self.rejected.append(rej)
        if self.on_reject is not None:
            self.on_reject(rej)

    def admissions(self, now: float = 0.0, can_admit=None) -> list[Slot]:
        """Pop arrived requests (in the policy's order) into free slots;
        each returned ``Slot`` enters the ``prefilling`` state — the
        engine feeds its prompt into the cache (in one shot or chunk by
        chunk) and then calls ``started``. ``can_admit(request)`` is the
        engine's resource gate (paged-pool block availability); a False
        holds the policy's head — backpressure stalls, it never
        reorders around resources."""
        out = []
        while self.free:
            req = self.policy.head(now)
            if req is None:
                break
            if can_admit is not None and not can_admit(req):
                break
            self.policy.pop()
            slot = Slot(index=self.free.pop(), request=req, admitted_at=now)
            self.prefilling[slot.index] = slot
            out.append(slot)
        return out

    # ------------------------------------------------------- engine hooks

    def started(self, slot: Slot, first_token: int, now: float = 0.0) -> None:
        """Prefill done: prompt is in the cache, first token sampled."""
        self.prefilling.pop(slot.index, None)
        self.slots[slot.index] = slot
        slot.length = len(slot.request.prompt)
        slot.prefilled = slot.length
        slot.last_token = int(first_token)
        slot.generated = [int(first_token)]
        slot.first_token_at = now
        if self.on_token is not None:
            self.on_token(slot, int(first_token), now)
        self._maybe_finish(slot, now)

    def decoded(self, tokens: dict, now: float = 0.0) -> None:
        """One decode tick: ``tokens[slot_index]`` is the token sampled
        for that slot. The decode step wrote the *previous* token's KV at
        position ``length``, so every active slot grows by one."""
        for idx, tok in tokens.items():
            slot = self.slots.get(idx)
            if slot is None:
                continue
            slot.length += 1
            slot.last_token = int(tok)
            slot.generated.append(int(tok))
            if self.on_token is not None:
                self.on_token(slot, int(tok), now)
            self._maybe_finish(slot, now)

    def _maybe_finish(self, slot: Slot, now: float) -> None:
        req = slot.request
        if req.eos_id is not None and slot.generated[-1] == req.eos_id:
            reason = "eos"
        elif len(slot.generated) >= req.max_new_tokens:
            reason = "length"
        elif slot.length >= self.max_seq:
            reason = "cache_full"   # no room to write the next token's KV
        else:
            return
        fin = Finished(
            request=req, tokens=slot.generated, reason=reason,
            admitted_at=slot.admitted_at, first_token_at=slot.first_token_at,
            finished_at=now, prompt_blocks_shared=slot.shared_blocks)
        self.finished.append(fin)
        del self.slots[slot.index]
        self.free.append(slot.index)
        if self.on_finish is not None:
            self.on_finish(fin)

    # ------------------------------------------------------------- state

    @property
    def queue(self) -> SchedulerPolicy:
        """The policy's waiting queue (len / truthiness view)."""
        return self.policy

    def head(self, now: float = 0.0) -> Optional[Request]:
        """The next admissible request in policy order, if arrived."""
        return self.policy.head(now)

    def pop_head(self) -> Request:
        """Remove the request the last ``head()`` call returned."""
        return self.policy.pop()

    def next_arrival(self) -> Optional[float]:
        return self.policy.next_arrival()

    def active(self) -> list[Slot]:
        return sorted(self.slots.values(), key=lambda s: s.index)

    def has_work(self) -> bool:
        return bool(self.slots or self.prefilling or len(self.policy))

    def utilization(self) -> float:
        return len(self.slots) / self.max_slots

    def concurrency(self) -> int:
        """Sequences currently holding cache resources."""
        return len(self.slots) + len(self.prefilling)
