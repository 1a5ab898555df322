"""Continuous-batching generation engine over a slot-based KV pool.

The port of ``repro/serve/batching.py``. One decode step runs every tick
over *all* slots of the KV pool, and prefills are admitted between ticks
into whatever slots are free, so requests of different lengths enter and
leave the batch continuously. Prompts are right-padded to a bucket
multiple; padded positions are masked by the per-slot length and
overwritten as the sequence grows.

Two pool backends, selected by ``ServeConfig.block_size``:

- **contiguous** (``block_size=None``): one ``(max_slots, max_seq)``
  region per slot, per-slot lengths as the vector ``cache_index``. A
  prompt longer than ``layers.DENSE_ATTN_MAX`` prefills through the
  flash-attention kernel on the card. The only backend for SSM/hybrid
  models, whose prompts prefill unpadded (``prefill_multiple=1``): the
  recurrent state would integrate padding.
- **paged** (``block_size=N``): fixed-size KV blocks in one shared
  arena (``transformer.init_paged_pool``), per-request block tables, a
  host-side block allocator with refcounts + copy-on-write, prefix
  sharing keyed on ``Request.prefix_id``, and chunked prefill — long
  prompts enter the cache in block-multiple chunks that interleave with
  decode ticks (``repro_torch.serve.paging``). With
  ``ServeConfig.paged_kernel`` decode attention reads the arena in
  place through the paged-attention kernel.

With a ``packed`` plan the MLP projections run through the block-sparse
kernel on either backend. Admission order is a
:mod:`~repro_torch.serve.policies` policy selected by
``ServeConfig.scheduler``. Tokens are sampled per request from the
counter-based streams of ``serve.engine.sample_tokens``, so a request
with its own seed samples the same tokens whatever batch it shares.

The tick loop is driven through a small *feed* seam: ``run`` wires in a
batch feed (every request submitted up front, the loop ends when they
are served) while ``serve_forever`` wires in a live feed that pulls
from a thread-safe submission queue and emits per-token events; the
streaming gateway (``repro_torch.serve.gateway``) runs it in a
background thread. Both run the same admission, prefill and decode
code, so the gateway's tokens are those of driving the engine directly.

With the span log on (``serve/metrics.py::SPANS``) each decode burst,
tick, prefill chunk and paged admission and copy-on-write pass records
its host interval (``common/spans.py``).
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import time
from collections import Counter
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.common.spans import LOG as SPANS
from repro_torch.common.tree import tree_device
from repro_torch.models import transformer as T
from repro_torch.models.specs import AttentionSpec, ModelConfig
from repro_torch.serve import metrics as M
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import (make_prefill_step, make_serve_step,
                                      make_sparse_mlp_apply, request_key,
                                      sample_tokens)
from repro_torch.serve.metrics import MetricsRegistry
from repro_torch.serve.paging import (BlockAllocator, PrefixCache,
                                      make_paged_decode_step,
                                      make_paged_prefill_step)
from repro_torch.serve.scheduler import Scheduler


@dataclasses.dataclass
class ServeStats:
    ticks: int
    wall_s: float
    generated_tokens: int
    tokens_per_s: float
    slot_utilization: float     # mean active/max_slots over decode ticks
    prefills: int               # completed prompt prefills
    rejected: int
    prefill_chunks: int = 0     # prefill launches (>= prefills when
    #                             chunked prefill splits prompts)
    peak_concurrency: int = 0   # max sequences holding cache at once
    prompt_blocks_shared: int = 0   # paged: prefix-cache block hits
    prefix_hit_rate: float = 0.0    # shared / shareable prompt blocks
    reject_reasons: dict = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        """JSON-safe dump (the gateway's /metrics stats block)."""
        return dataclasses.asdict(self)


class _BatchFeed:
    """Default feed: every request was submitted by ``run``; the loop
    ends when the scheduler drains, and idles by sleeping until the next
    future arrival."""

    def pump(self, sched, now: float) -> None:
        pass

    def drained(self) -> bool:
        return True

    def wait(self, sched, clock) -> None:
        if sched.prefilling:
            return                      # chunked prefill still progresses
        arrival = sched.next_arrival()
        if arrival is not None:
            delay = arrival - clock()
            if delay > 0:
                time.sleep(delay)

    def emit_token(self, slot, token: int, now: float) -> None:
        pass

    def emit_finished(self, fin) -> None:
        pass

    def emit_rejected(self, rej) -> None:
        pass


class _QueueFeed(_BatchFeed):
    """Live feed: requests arrive on a thread-safe ``queue.Queue`` and
    events stream out through ``emit``, the gateway's bridge into the
    tick loop. ``stop`` (a ``threading.Event``) ends the loop once the
    inbox and the scheduler are both drained."""

    def __init__(self, inbox: queue_mod.Queue, emit: Callable,
                 stop=None, poll_s: float = 0.002):
        self.inbox = inbox
        self.emit = emit
        self.stop = stop
        self.poll_s = poll_s
        self._staged: list = []

    def pump(self, sched, now: float) -> None:
        while True:
            if self._staged:
                req = self._staged.pop(0)
            else:
                try:
                    req = self.inbox.get_nowait()
                except queue_mod.Empty:
                    break
            # the submission's arrival is its intake time on the engine
            # clock: queue-wait metrics start here
            req.arrival = now
            sched.submit(req)

    def drained(self) -> bool:
        return (self.stop is not None and self.stop.is_set()
                and not self._staged and self.inbox.empty())

    def wait(self, sched, clock) -> None:
        if sched.prefilling:
            return
        try:        # block briefly for the next submission, don't spin
            self._staged.append(self.inbox.get(timeout=self.poll_s))
        except queue_mod.Empty:
            pass

    def emit_token(self, slot, token: int, now: float) -> None:
        self.emit(("token", slot.request.uid,
                   len(slot.generated) - 1, token))

    def emit_finished(self, fin) -> None:
        self.emit(("finished", fin))

    def emit_rejected(self, rej) -> None:
        self.emit(("rejected", rej))


class ContinuousEngine:
    """Slot-pool engine: policy-ordered admission, per-tick batched
    decode, immediate slot reuse after eviction. Runs on the params'
    device; the weights are cast to the compute dtype once."""

    def __init__(self, params, cfg: ModelConfig,
                 serve: Optional[ServeConfig] = None,
                 packed: Optional[dict] = None):
        serve = serve if serve is not None else ServeConfig()
        if cfg.scan_layers:
            raise ValueError("continuous batching needs an unrolled config "
                             "(cfg.replace(scan_layers=False))")
        hybrid = any(not isinstance(cfg.layer(i).mixer, AttentionSpec)
                     for i in range(cfg.n_layers))
        if serve.prefill_multiple != 1 and hybrid:
            # attention masks padded prefill positions via the per-slot
            # length; an SSM integrates them into its recurrent state
            raise ValueError("SSM/hybrid mixers need unpadded prefills: "
                             "pass prefill_multiple=1")
        if serve.paged and hybrid:
            raise ValueError("paged KV pools support attention-only "
                             "configs (SSM state is recurrent, not "
                             "positional)")
        self.serve = serve
        self.cfg = cfg
        self.params = T.cast_params(params, serve.compute_dtype)
        self.device = tree_device(self.params)
        self.max_slots = serve.max_slots
        self.max_seq = serve.max_seq
        self.cache_dtype = serve.cache_dtype
        self.prefill_multiple = serve.prefill_multiple
        # per-stage observability: request latencies + tick gauges
        self.metrics = MetricsRegistry()
        mlp_apply = (make_sparse_mlp_apply(packed, serve.group_experts,
                                           serve.ragged_moe, serve.quant)
                     if packed else None)
        if serve.paged:
            self._prefill = make_paged_prefill_step(
                cfg, serve.compute_dtype, mlp_apply)
            self._decode = make_paged_decode_step(
                cfg, serve.compute_dtype, mlp_apply,
                paged_kernel=serve.paged_kernel)
        else:
            self._prefill = make_prefill_step(cfg, serve.compute_dtype,
                                              mlp_apply)
            self._decode = make_serve_step(cfg, serve.compute_dtype,
                                           mlp_apply)

    @classmethod
    def from_artifact(cls, artifact, serve: Optional[ServeConfig] = None,
                      *, sparse: bool = True) -> "ContinuousEngine":
        """Serve a :class:`~repro_torch.core.artifact.PrunedArtifact`:
        its params, pruned config and (with ``sparse=True``) its saved
        block plans, with no ``pack_model`` at startup."""
        packed = artifact.packed if sparse else None
        return cls(artifact.params, artifact.cfg, serve,
                   packed=packed or None)

    # ------------------------------------------------------------ pieces

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def _bucket(self, n: int) -> int:
        m = self.prefill_multiple
        return min(-(-n // m) * m, self.max_seq)

    def _request_sampling(self, slot, state) -> None:
        """Bind the request's sampling stream to its slot."""
        req = slot.request
        t = (req.temperature if req.temperature is not None
             else state["default_temp"])
        state["keys"][slot.index] = request_key(req.seed, req.uid,
                                                state["run_seed"])
        state["temps"][slot.index] = t

    def _sample_first(self, logits_row, slot, state) -> int:
        """Sample the request's first token (stream count 0) from its
        prefill logits (its one sync)."""
        k = SPANS.open("sample_first") if SPANS.on else -1
        i = slot.index
        tok = int(sample_tokens(
            logits_row[None], self._tensor(state["keys"][i:i + 1]),
            torch.zeros((1,), dtype=torch.int64, device=self.device),
            state["temps"][i:i + 1], self.cfg.vocab)[0])
        if k >= 0:
            SPANS.close(k)
        return tok

    # ----------------------------------------------------------- prefill

    def _prefill_slot(self, pool, slot, state):
        """Contiguous pool: prefill one request into its slot; returns
        (pool, first_token)."""
        prompt = np.asarray(slot.request.prompt, np.int64)
        s0 = len(prompt)
        kc = (SPANS.open("prefill_chunk", uid=slot.request.uid, start=0,
                         n=s0) if SPANS.on else -1)
        kp = SPANS.open("chunk.prep") if SPANS.on else -1
        padded = np.zeros((1, self._bucket(s0)), np.int64)
        padded[0, :s0] = prompt
        row = T.init_cache(self.cfg, 1, self.max_seq, self.cache_dtype,
                           self.device)
        tokens = self._tensor(padded)
        if kp >= 0:
            SPANS.close(kp)
        logits, row = self._prefill(self.params, tokens, row)
        pool = T.write_cache_slot(pool, row, slot.index)
        tok = self._sample_first(logits[0, s0 - 1, :], slot, state)
        if kc >= 0:
            SPANS.close(kc)
        return pool, tok

    def _prefill_chunk(self, pool, slot, tables, state):
        """Paged pool: feed the next chunk of the request's prompt in;
        returns (pool, first_token_or_None)."""
        prompt = slot.request.prompt
        s0 = len(prompt)
        start = slot.prefilled
        chunk = self.serve.prefill_chunk or (s0 - start)
        end = min(start + chunk, s0)
        n = end - start
        kc = (SPANS.open("prefill_chunk", uid=slot.request.uid, start=start,
                         n=n) if SPANS.on else -1)
        kp = SPANS.open("chunk.prep") if SPANS.on else -1
        padded = np.zeros((1, self._bucket(n)), np.int64)
        padded[0, :n] = prompt[start:end]
        args = (self._tensor(padded),
                self._tensor(tables[slot.index:slot.index + 1]),
                self._tensor([start]), self._tensor([n]))
        if kp >= 0:
            SPANS.close(kp)
        logits, pool = self._prefill(self.params, pool, *args)
        slot.prefilled = end
        tok = (None if end < s0 else
               self._sample_first(logits[0, n - 1, :], slot, state))
        if kc >= 0:
            SPANS.close(kc)
        return pool, tok

    # -------------------------------------------------------------- run

    def _wire(self, sched, feed) -> None:
        """Route scheduler lifecycle events into the metrics and the
        feed."""
        def on_finish(fin):
            M.observe_finished(self.metrics, fin)
            feed.emit_finished(fin)

        def on_reject(rej):
            self.metrics.count(f"requests.rejected.{rej.reason}")
            feed.emit_rejected(rej)

        sched.on_token = feed.emit_token
        sched.on_finish = on_finish
        sched.on_reject = on_reject

    def _sampling_state(self, temperature: float, seed: int) -> dict:
        return {"keys": np.zeros((self.max_slots,), np.int64),
                "temps": np.zeros((self.max_slots,), np.float32),
                "default_temp": float(temperature), "run_seed": int(seed)}

    @torch.no_grad()
    def run(self, requests, temperature: float = 0.0, seed: int = 0,
            max_ticks: Optional[int] = None, max_burst: int = 8):
        """Serve ``requests`` to completion.

        Arrivals are seconds on the wall clock starting when ``run`` is
        called (``Request.arrival=0`` = available immediately). Returns
        ``(finished, stats)`` where ``finished`` is uid-sorted
        ``scheduler.Finished`` records.

        ``temperature`` and ``seed`` are *defaults* for requests that
        don't carry their own ``Request.temperature`` / ``Request.seed``.

        Decode runs in bursts of up to ``max_burst`` ticks that chain the
        sampled tokens on the device, so the hot loop syncs with the
        host scheduler once per burst. Bursts never exceed the smallest
        remaining per-slot budget, so the only waste is an EOS landing
        mid-burst (those tokens are dropped and the slot frees at the
        burst boundary); the generated sequences are identical to
        tick-by-tick decoding.
        """
        sched = Scheduler(self.max_slots, self.max_seq,
                          policy=self.serve.scheduler)
        feed = _BatchFeed()
        self._wire(sched, feed)
        for r in requests:
            sched.submit(r)
        return self._run(sched, feed, temperature, seed, max_ticks,
                         max_burst)

    @torch.no_grad()
    def serve_forever(self, inbox: queue_mod.Queue, emit: Callable, *,
                      stop, temperature: float = 0.0, seed: int = 0,
                      max_burst: int = 8, poll_s: float = 0.002):
        """Drive the tick loop off a live submission queue (the gateway
        runs this in a background thread).

        ``inbox`` is a thread-safe ``queue.Queue`` of
        :class:`~repro_torch.serve.scheduler.Request`; each submission's
        ``arrival`` is stamped with its intake time on the engine clock.
        ``emit(event)`` is called from the engine thread with
        ``("token", uid, index, token)``, ``("finished", Finished)`` and
        ``("rejected", Rejection)`` events, in generation order per
        request (tokens surface at burst boundaries, up to ``max_burst``
        at a time). ``stop`` is a ``threading.Event``: once set, the loop
        finishes the work it has, drains the inbox, and returns
        ``(finished, stats)`` as :meth:`run` does.

        Admission order, sampling streams and every step are shared with
        :meth:`run`: a request submitted here generates the tokens it
        would generate driving the engine directly."""
        sched = Scheduler(self.max_slots, self.max_seq,
                          policy=self.serve.scheduler)
        feed = _QueueFeed(inbox, emit, stop=stop, poll_s=poll_s)
        self._wire(sched, feed)
        return self._run(sched, feed, temperature, seed, None, max_burst)

    def _run(self, sched, feed, temperature, seed, max_ticks, max_burst):
        state = self._sampling_state(temperature, seed)
        if self.serve.paged:
            return self._run_paged(sched, state, max_ticks, max_burst, feed)
        return self._run_contiguous(sched, state, max_ticks, max_burst,
                                    feed)

    def _decode_burst(self, sched, pool, state, tick_state, max_ticks,
                      max_burst, tables=None):
        """One decode burst over the active slots (both backends);
        returns the updated pool, or None when there is nothing to
        decode."""
        active = sched.active()
        if not active:
            return None
        t_burst = time.perf_counter()
        remaining = min(
            min(s.request.max_new_tokens - len(s.generated),
                self.max_seq - s.length) for s in active)
        burst = max(1, min(max_burst, remaining))
        if max_ticks is not None:
            burst = min(burst, max_ticks - tick_state["ticks"])
        kb = (SPANS.open("decode_burst", rows=len(active), ticks=burst,
                         slots=self.max_slots) if SPANS.on else -1)
        kp = SPANS.open("burst.prep") if SPANS.on else -1
        tokens_in = np.zeros((self.max_slots, 1), np.int64)
        lengths = np.zeros((self.max_slots,), np.int64)
        counts = np.zeros((self.max_slots,), np.int64)
        for s in active:
            tokens_in[s.index, 0] = s.last_token
            lengths[s.index] = s.length
            counts[s.index] = len(s.generated)
        extra = (self._tensor(tables),) if tables is not None else ()
        toks_dev = self._tensor(tokens_in)
        lens_dev = self._tensor(lengths)
        counts_dev = self._tensor(counts)
        keys_dev = self._tensor(state["keys"])
        if kp >= 0:
            SPANS.close(kp)
        steps = []
        for _ in range(burst):
            kt = SPANS.open("tick") if SPANS.on else -1
            logits, pool = self._decode(self.params, pool, toks_dev,
                                        lens_dev, *extra)
            ks = SPANS.open("sample") if SPANS.on else -1
            sampled = sample_tokens(logits, keys_dev, counts_dev,
                                    state["temps"], self.cfg.vocab)
            if ks >= 0:
                SPANS.close(ks)
            steps.append(sampled)
            toks_dev = sampled[:, None]
            lens_dev = lens_dev + 1
            counts_dev = counts_dev + 1
            if kt >= 0:
                SPANS.close(kt)
        ks = SPANS.open("burst.sync") if SPANS.on else -1
        host = torch.stack(steps).cpu().numpy()     # one sync per burst
        if ks >= 0:
            SPANS.close(ks)
        kc = SPANS.open("burst.commit") if SPANS.on else -1
        for k in range(burst):
            sched.decoded({s.index: host[k, s.index] for s in active},
                          tick_state["clock"]())
            tick_state["util"].append(len(active) / self.max_slots)
            tick_state["ticks"] += 1
        burst_s = time.perf_counter() - t_burst
        m = self.metrics
        m.observe("tick.active_slots", len(active))
        m.observe("tick.prefill_backlog",
                  len(sched.prefilling) + len(sched.queue))
        if burst_s > 0:
            m.gauge("tick.tokens_per_s", burst * len(active) / burst_s)
        m.count("decode.ticks", burst)
        m.count("decode.tokens", burst * len(active))
        if kc >= 0:
            SPANS.close(kc)
        if kb >= 0:
            SPANS.close(kb)
        return pool

    def _stats(self, sched, tick_state, wall, prefills, chunks):
        finished = sorted(sched.finished, key=lambda f: f.request.uid)
        n_tok = sum(len(f.tokens) for f in finished)
        shared = sum(f.prompt_blocks_shared for f in finished)
        shareable = 0
        if self.serve.paged:
            bs = self.serve.block_size
            shareable = sum((len(f.request.prompt) - 1) // bs
                            for f in finished
                            if f.request.prefix_id is not None)
        util = tick_state["util"]
        return finished, ServeStats(
            ticks=tick_state["ticks"], wall_s=wall,
            generated_tokens=n_tok,
            tokens_per_s=n_tok / wall if wall > 0 else 0.0,
            slot_utilization=float(np.mean(util)) if util else 0.0,
            prefills=prefills, rejected=len(sched.rejected),
            prefill_chunks=chunks,
            peak_concurrency=tick_state["peak"],
            prompt_blocks_shared=shared,
            prefix_hit_rate=shared / shareable if shareable else 0.0,
            reject_reasons=dict(Counter(r.reason
                                        for r in sched.rejected)))

    # ------------------------------------------------- contiguous backend

    def _run_contiguous(self, sched, state, max_ticks, max_burst, feed):
        pool = T.init_cache_pool(self.cfg, self.max_slots, self.max_seq,
                                 self.cache_dtype, self.device)
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0  # noqa: E731
        tick_state = {"ticks": 0, "util": [], "peak": 0, "clock": clock}
        prefills = 0

        while True:
            feed.pump(sched, clock())
            if not sched.has_work():
                if feed.drained():
                    break
                feed.wait(sched, clock)
                continue
            if max_ticks is not None and tick_state["ticks"] >= max_ticks:
                break
            for slot in sched.admissions(clock()):
                self._request_sampling(slot, state)
                pool, tok = self._prefill_slot(pool, slot, state)
                prefills += 1
                sched.started(slot, tok, clock())
            tick_state["peak"] = max(tick_state["peak"],
                                     sched.concurrency())
            new_pool = self._decode_burst(sched, pool, state, tick_state,
                                          max_ticks, max_burst)
            if new_pool is None:
                feed.wait(sched, clock)     # future arrivals / live inbox
                continue
            pool = new_pool

        return self._stats(sched, tick_state, clock(), prefills, prefills)

    # ------------------------------------------------------ paged backend

    def _blocks_for(self, req, prefix: PrefixCache) -> int:
        """Blocks a request must *own*: enough for every KV position it
        can write (prompt + budget, capped at max_seq), minus blocks a
        prefix-cache hit would map in, plus one copy-on-write reserve
        when entering on shared blocks. Reserved in full at admission,
        so neither decode nor COW can run out of blocks mid-request."""
        bs = self.serve.block_size
        cap = min(len(req.prompt) + req.max_new_tokens, self.max_seq)
        shared = len(prefix.match(req.prefix_id, req.prompt))
        own = -(-cap // bs) - shared
        return own + (1 if shared else 0)

    def _run_paged(self, sched, state, max_ticks, max_burst, feed):
        serve = self.serve
        bs = serve.block_size
        alloc = BlockAllocator(serve.arena_blocks, bs)
        prefix = PrefixCache(alloc)
        pool = T.init_paged_pool(self.cfg, serve.arena_blocks, bs,
                                 self.cache_dtype, self.device)
        tables = np.full((self.max_slots, serve.blocks_per_seq),
                         alloc.scratch, np.int32)
        slot_blocks: dict[int, list] = {}
        # slot index -> block pre-claimed at admission for copy-on-write
        # (only slots that entered on shared prefix blocks have one)
        slot_reserve: dict[int, int] = {}
        t0 = time.perf_counter()
        clock = lambda: time.perf_counter() - t0  # noqa: E731
        tick_state = {"ticks": 0, "util": [], "peak": 0, "clock": clock}
        prefills = chunks = 0

        # blocks are *reserved* inside the admission gate — several
        # requests can be admitted in one scheduler call, so checking
        # n_free without claiming would over-admit against the same
        # free blocks
        pending: dict[int, tuple] = {}      # uid -> (shared, owned)

        def can_admit(req):
            if req.uid in pending:
                return True
            shared = prefix.match(req.prefix_id, req.prompt)
            need = self._blocks_for(req, prefix)
            if need > alloc.n_free:
                return False
            if shared:
                alloc.retain(shared)
            pending[req.uid] = (list(shared), alloc.alloc(need))
            return True

        def release_if_finished(slot):
            if (slot.index not in sched.slots
                    and slot.index not in sched.prefilling):
                blocks = slot_blocks.pop(slot.index, None)
                if blocks:
                    alloc.release(blocks)
                reserve = slot_reserve.pop(slot.index, None)
                if reserve is not None:
                    alloc.release([reserve])    # COW never fired
                tables[slot.index, :] = alloc.scratch

        while True:
            feed.pump(sched, clock())
            if not sched.has_work():
                if feed.drained():
                    break
                feed.wait(sched, clock)
                continue
            if max_ticks is not None and tick_state["ticks"] >= max_ticks:
                break

            # ---- admissions: map shared prefix blocks + claim the rest
            ka = SPANS.open("admit") if SPANS.on else -1
            admitted = sched.admissions(clock(), can_admit)
            if (not admitted and not sched.slots and not sched.prefilling
                    and sched.head(clock()) is not None):
                # head blocked with the pool idle: cached prefixes are
                # the only block holders — drop them and retry; a head
                # that still doesn't fit can never run
                if len(prefix):
                    prefix.drop_all()
                    admitted = sched.admissions(clock(), can_admit)
                head = sched.head(clock())
                if (not admitted and head is not None
                        and not can_admit(head)):
                    sched.reject(sched.pop_head(), "insufficient_blocks",
                                 clock())
                    if ka >= 0:
                        SPANS.close(ka)
                    continue
            for slot in admitted:
                req = slot.request
                shared, owned = pending.pop(req.uid)
                if shared:
                    # the last claimed block is the COW reserve: held
                    # outside the table until a shared-block write needs
                    # a private copy (or released at finish, unused)
                    slot_reserve[slot.index] = owned.pop()
                row = shared + owned
                tables[slot.index, :] = alloc.scratch
                tables[slot.index, :len(row)] = row
                slot_blocks[slot.index] = row
                slot.shared_blocks = len(shared)
                slot.prefilled = len(shared) * bs
                self._request_sampling(slot, state)
            for shared, owned in pending.values():  # reserved, not admitted
                if shared:
                    alloc.release(shared)
                alloc.release(owned)
            pending.clear()
            tick_state["peak"] = max(tick_state["peak"],
                                     sched.concurrency())
            if ka >= 0:
                SPANS.close(ka)

            # ---- chunked prefill: one chunk per prefilling slot per
            # tick, interleaved with the decode burst below; the policy
            # may cap chunk launches per tick while slots are decoding
            prefill_slots = list(sched.prefilling.values())
            budget = sched.policy.prefill_budget(len(sched.slots))
            if budget is not None:
                prefill_slots = prefill_slots[:budget]
            for slot in prefill_slots:
                pool, tok = self._prefill_chunk(pool, slot, tables, state)
                chunks += 1
                if tok is not None:
                    prefills += 1
                    sched.started(slot, tok, clock())
                    prefix.register(slot.request.prefix_id,
                                    slot.request.prompt,
                                    tables[slot.index])
                    release_if_finished(slot)

            # ---- copy-on-write guard: a decode write may never land in
            # a block another sequence can still read. The private copy
            # comes out of the slot's admission-time reserve, never a
            # fresh alloc — a full arena here must not raise OutOfBlocks
            kw = SPANS.open("cow_guard") if SPANS.on else -1
            active = sched.active()
            for s in active:
                j = s.length // bs
                old = int(tables[s.index][j])
                reserve = slot_reserve.get(s.index)
                pool = alloc.ensure_writable(
                    tables[s.index], j, pool, reserve=reserve)
                new = int(tables[s.index][j])
                if new != old:
                    # the ownership list tracks the swap: the shared
                    # block's ref was dropped by ensure_writable; the
                    # private copy is released at finish instead
                    row = slot_blocks[s.index]
                    row[row.index(old)] = new
                    slot_reserve.pop(s.index, None)
                elif reserve is not None:
                    # first guarded tick and no copy was needed: every
                    # shared block sits strictly below the write frontier
                    # and the frontier block is ours, so COW can never
                    # fire for this slot again — return the reserve
                    alloc.release([reserve])
                    slot_reserve.pop(s.index, None)
            if kw >= 0:
                SPANS.close(kw)

            # the decode step runs over *every* slot row; slots still
            # mid-chunked-prefill must not have their real blocks
            # stomped by the inactive-row write at position 0, so their
            # table rows are masked to the scratch block for the burst
            decode_tables = tables
            if sched.prefilling:
                decode_tables = tables.copy()
                decode_tables[list(sched.prefilling)] = alloc.scratch
            self.metrics.gauge("tick.free_blocks", alloc.n_free)
            new_pool = self._decode_burst(sched, pool, state, tick_state,
                                          max_ticks, max_burst,
                                          tables=decode_tables)
            if new_pool is None:
                feed.wait(sched, clock)     # future arrivals / live inbox
                continue
            pool = new_pool
            for s in active:
                release_if_finished(s)

        prefix.drop_all()
        # the run's allocator, kept so a caller can check that every
        # block came back (n_free == arena_blocks) once the run is over
        self.last_allocator = alloc
        return self._stats(sched, tick_state, clock(), prefills, chunks)
