"""One run of one cell: set-up, the measured window, the traced slice,
the check against the reference, and the result.

Everything that belongs to a cell is found by name: the cell's entry in
``BENCHMARK.json``, its configuration file (``configs/<config>.json``),
its traffic file (``traffic/<traffic>.json``), its check limits
(``checks/<cell>.json``) and one reader per metric
(``metrics/<metric>.py``, a ``read(ctx)`` that returns a number, or
None where it finds nothing to read).

The window drives ``ContinuousEngine.serve_forever``, the live queue
feed the HTTP gateway runs, without HTTP. Clients are logical: each has
one request in flight and sends its next from the engine's ``finished``
event, so the load adds no thread. The harness times every event it
gets back, and wraps the engine's two calls per loop (a prefill chunk,
a decode burst) to log their host time and work; in a traced run the
same wrappers start and stop ``torch.profiler`` at call boundaries and
put a marker kernel on the device before each call.
"""
from __future__ import annotations

import bisect
import dataclasses
import gc
import importlib.util
import json
import queue
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

from portbench import modelgen, reference, roofline
from portbench import traffic as traffic_mod

HERE = Path(__file__).resolve().parent
TRACE_AT = 0.5          # the traced slice starts half-way into the window
TRACE_MAX_S = 3.0       # and lasts this long (at most a quarter window)
DRAIN_S = 120.0         # longest wait for the engine to drain after it


def load_json(path) -> dict:
    return json.loads(Path(path).read_text())


def cell_entries(manifest: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


def cell_files(manifest: dict, cell: str) -> tuple:
    """The cell's entry and its configuration, traffic and check files."""
    w = next(x for x in manifest["workloads"] if x["name"] == cell)
    return w, (load_json(HERE / "configs" / f"{w['config']}.json"),
               load_json(HERE / "traffic" / f"{w['traffic']}.json"),
               load_json(HERE / "checks" / f"{cell}.json"))


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Rec:
    """One request as its client sees it (host clock)."""
    req: object
    client: int | None
    sent: float
    first: float | None = None
    last: float | None = None
    n: int = 0
    done: float | None = None
    fin: object = None
    rejected: bool = False


class Driver:
    """The engine thread, the logical clients and the call log."""

    def __init__(self, engine, plan: list, max_burst: int, cuda: bool):
        self.engine = engine
        self.plan = plan                      # per client: its requests
        self.next_round = [0] * len(plan)
        self.max_burst = max_burst
        self.cuda = cuda
        self.inbox: queue.Queue = queue.Queue()
        self.stop = threading.Event()
        self.recs: dict = {}
        self.uid = 0
        self.t0 = self.t_end = float("inf")
        self.open = False
        self.window_tokens = 0
        self.warm_left = 0
        self.warm_done = threading.Event()
        self.calls: list = []
        self.error = None
        self.result = None
        self.lock = threading.Lock()
        # the traced slice: starts at the first call past ``trace_at``
        self.trace_at = None
        self.slice_s = 0.0
        self.prof = None
        self.tracing = False
        self.trace: dict = {}
        self._install()
        self.thread = threading.Thread(target=self._serve, daemon=True)

    # ------------------------------------------------------- engine side

    def _install(self) -> None:
        eng = self.engine
        burst0, chunk0 = eng._decode_burst, eng._prefill_chunk
        chunk_size = eng.serve.prefill_chunk

        def decode_burst(sched, pool, state, tick_state, max_ticks,
                         max_burst, tables=None):
            self._slice_start()
            lens = [s.length for s in sched.active()]
            ticks0 = tick_state["ticks"]
            if lens:
                self._mark()
            t = time.perf_counter()
            out = burst0(sched, pool, state, tick_state, max_ticks,
                         max_burst, tables=tables)
            t1 = time.perf_counter()
            if tick_state["ticks"] > ticks0:
                self.calls.append({"kind": "decode", "t0": t, "t1": t1,
                                   "ticks": tick_state["ticks"] - ticks0,
                                   "lens": lens, "traced": self.tracing,
                                   "slots": eng.max_slots})
            self._slice_stop()
            return out

        def prefill_chunk(pool, slot, tables, state):
            start = slot.prefilled
            n = min(start + chunk_size, len(slot.request.prompt)) - start
            self._mark()
            t = time.perf_counter()
            out = chunk0(pool, slot, tables, state)
            self.calls.append({"kind": "prefill", "t0": t,
                               "t1": time.perf_counter(), "start": start,
                               "n": n, "traced": self.tracing})
            return out

        eng._decode_burst = decode_burst
        eng._prefill_chunk = prefill_chunk

    def _serve(self) -> None:
        try:
            self.result = self.engine.serve_forever(
                self.inbox, self._emit, stop=self.stop, temperature=0.0,
                seed=0, max_burst=self.max_burst)
        except BaseException as e:           # surfaced by the main thread
            self.error = e
            self.warm_done.set()

    def _emit(self, ev) -> None:
        now = time.perf_counter()
        if ev[0] == "token":
            rec = self.recs[ev[1]]
            if ev[2] == 0:
                rec.first = now
            rec.last = now
            rec.n = ev[2] + 1
            if rec.client is not None and self.t0 <= now <= self.t_end:
                self.window_tokens += 1
            return
        rec = self.recs[ev[1].request.uid]
        rec.done = now
        if ev[0] == "finished":
            rec.fin = ev[1]
        else:
            rec.rejected = True
        if rec.client is None:
            self.warm_left -= 1
            if self.warm_left == 0:
                self.warm_done.set()
        elif self.open and now < self.t_end:
            self._send(rec.client, now)

    # ----------------------------------------------------------- clients

    def _submit(self, prompt, max_new, client, now) -> None:
        from repro_torch.serve.scheduler import Request
        with self.lock:                   # main and engine threads send
            req = Request(uid=self.uid, prompt=prompt,
                          max_new_tokens=max_new)
            self.recs[self.uid] = Rec(req=req, client=client, sent=now)
            self.uid += 1
        self.inbox.put(req)

    def _send(self, client: int, now: float) -> None:
        r = self.next_round[client]
        if r >= len(self.plan[client]):
            raise RuntimeError(f"client {client} ran out of requests: "
                               "raise the traffic file's rounds")
        self.next_round[client] = r + 1
        prompt, max_new = self.plan[client][r]
        self._submit(prompt, max_new, client, now)

    def warm(self, requests: list, timeout: float) -> None:
        self.thread.start()
        self.warm_left = len(requests)
        for prompt, max_new in requests:
            self._submit(prompt, max_new, None, time.perf_counter())
        if not self.warm_done.wait(timeout) or self.error is not None:
            raise RuntimeError("warm-up did not finish") from self.error
        if any(r.rejected for r in self.recs.values()):
            raise RuntimeError("the engine refused a warm-up request")

    def start(self, seconds: float, timeout: float) -> None:
        """Send every client's first request, wait until each has its
        first token (the caches the load keeps are filled: set-up the
        traffic needs), then open the window."""
        self.open = True
        now = time.perf_counter()
        for c in range(len(self.plan)):
            self._send(c, now)
        first = [r for r in self.recs.values() if r.client is not None]
        limit = now + timeout
        while any(r.first is None for r in first):
            if self.error is not None or time.perf_counter() > limit:
                raise RuntimeError("the load's first requests did not "
                                   "start") from self.error
            time.sleep(0.01)
        self.t_end = float("inf")
        self.t0 = time.perf_counter()
        self.t_end = self.t0 + seconds

    def close(self, drain_s: float = 0.0) -> None:
        """End the load: no more sends; up to ``drain_s`` seconds for the
        requests still in flight to finish their budgets (answers for the
        check, counted by no metric); the budgets of those still left
        cut to what they have (the clients cancel), then stop and join
        the engine. ``t_drained`` is when the wait ended."""
        self.open = False
        limit = time.perf_counter() + drain_s
        while (drain_s > 0 and self.error is None
               and time.perf_counter() < limit
               and any(r.done is None for r in list(self.recs.values()))):
            time.sleep(0.01)
        self.t_drained = max(self.t_end, time.perf_counter()
                             if drain_s > 0 else self.t_end)
        for rec in list(self.recs.values()):
            if rec.done is None:
                rec.req.max_new_tokens = 1
        self.stop.set()
        self.thread.join(DRAIN_S)
        if self.thread.is_alive():
            raise RuntimeError("the engine did not drain after the window")
        if self.error is not None:
            raise RuntimeError("the engine failed") from self.error

    # ------------------------------------------------------ traced slice

    def _mark(self) -> None:
        if self.tracing:
            torch.cuda._sleep(1)

    def _slice_start(self) -> None:
        if (self.trace_at is None or self.trace or
                time.perf_counter() < self.trace_at):
            return
        from torch.profiler import ProfilerActivity, profile

        from portbench.port import counter_snapshot
        torch.cuda.synchronize()
        self.trace["counters0"] = counter_snapshot()
        self.trace["first_call"] = len(self.calls)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        self.tracing = True
        self.trace["t0"] = time.perf_counter()

    def _slice_stop(self) -> None:
        if not self.tracing or (time.perf_counter()
                                < self.trace["t0"] + self.slice_s):
            return
        from portbench.port import counter_snapshot
        torch.cuda.synchronize()
        self.trace["t1"] = time.perf_counter()
        self.prof.stop()
        self.tracing = False
        self.trace["end_call"] = len(self.calls)
        self.trace["counters1"] = counter_snapshot()


# ------------------------------------------------------------ the trace

def read_trace(driver: Driver) -> dict | None:
    """Device time of the traced slice by kernel class and name, and by
    class within each kind of call (the work between a call's marker and
    the next; None where markers and calls disagree), its busy union, and
    its idle gaps by what the host was doing."""
    tr = driver.trace
    if "t1" not in tr:
        return None
    from torch.autograd import DeviceType
    evs = sorted(((e.time_range.start, e.time_range.end, e.name)
                  for e in driver.prof.events()
                  if e.device_type == DeviceType.CUDA),
                 key=lambda x: x[0])
    calls = driver.calls[tr["first_call"]:tr["end_call"]]
    marks = [e for e in evs if roofline.kernel_class(e[2]) == "marker"]
    work = [e for e in evs if roofline.kernel_class(e[2]) != "marker"]
    by_class: dict = {}
    by_name: dict = {}
    for s, e, name in work:
        c = roofline.kernel_class(name)
        by_class[c] = by_class.get(c, 0.0) + (e - s) / 1e6
        short = name.replace("(anonymous namespace)::", "")
        short = short.split("(")[0].removeprefix("void ")[:96]
        by_name[short] = by_name.get(short, 0.0) + (e - s) / 1e6
    gaps: dict = {}
    by_kind = None

    def add(label, us):
        gaps[label] = gaps.get(label, 0.0) + us / 1e6
    if len(marks) == len(calls) and work:
        starts = [m[0] for m in marks]
        kinds = [c["kind"] for c in calls]
        by_kind = {}
        for s, e, name in work:
            j = bisect.bisect_right(starts, s) - 1
            k = by_kind.setdefault(kinds[j] if j >= 0 else "before", {})
            c = roofline.kernel_class(name)
            k[c] = k.get(c, 0.0) + (e - s) / 1e6
        j, end = 0, work[0][1]          # j: markers started by ``end``
        for s1, e1, _ in work[1:]:
            if s1 > end:
                while j < len(starts) and starts[j] <= end:
                    j += 1
                k = j
                while k < len(starts) and starts[k] < s1:
                    k += 1
                if k > j:   # a call started in the gap: the loop, then it
                    add("engine loop between calls", starts[j] - end)
                    add(f"{kinds[k - 1]} call host dispatch",
                        s1 - starts[j])
                elif j > 0:
                    add(f"{kinds[j - 1]} call host dispatch", s1 - end)
            end = max(end, e1)
    else:
        add("unattributed: markers and calls disagree", 0.0)
    wall = tr["t1"] - tr["t0"]
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return {"wall_s": wall,
            "busy_s": roofline.busy_s([(s / 1e6, e / 1e6)
                                       for s, e, _ in work]),
            "by_class_s": by_class, "by_kind_class_s": by_kind,
            "calls": calls,
            "counters0": tr["counters0"], "counters1": tr["counters1"],
            "device_ops": top(by_name), "idle_gaps": top(gaps)}


# ------------------------------------------------------------ the check

def sample_finished(recs: list, seed: int, check: dict) -> list:
    """The finished requests the check compares: the one with the most
    served tokens, then others in an order drawn from the seed, until
    ``min_tokens`` served tokens or ``max_requests`` requests."""
    done = sorted(recs, key=lambda r: (-len(r.fin.tokens), r.req.uid))
    if not done:
        return []
    rng = np.random.default_rng([seed & modelgen.MASK, 0xC4EC])
    rest = [done[i] for i in 1 + rng.permutation(len(done) - 1)]
    out, n = [done[0]], len(done[0].fin.tokens)
    for r in rest:
        if n >= check["min_tokens"] or len(out) >= check["max_requests"]:
            break
        out.append(r)
        n += len(r.fin.tokens)
    return out


def reference_logits(desc, params, serving, picked,
                     quant: str = "none") -> list:
    """The reference's logits at every position that predicts a served
    token of the compared requests (``reference.logits``)."""
    seqs = [(list(r.req.prompt) + list(r.fin.tokens[:-1]),
             len(r.req.prompt)) for r in picked]
    return reference.logits(desc, params, seqs, serving, quant=quant)


def token_gaps(ref: list, picked: list, low: list | None = None):
    """For every served token of the compared requests, the gap by which
    its float32 reference logit (``ref``) lies below the reference's best
    at its position (0 where it is the reference's greedy token). With
    ``low`` (the reference's logits in a lower precision) the token judged
    at each position is the one ``low`` puts first."""
    out = []
    for j, (r, lg) in enumerate(zip(picked, ref)):
        if low is None:
            tok = torch.as_tensor(r.fin.tokens, device=lg.device)
        else:
            tok = low[j].argmax(-1)
        best = lg.max(-1).values
        out.append(best - lg.gather(1, tok[:, None])[:, 0])
    return torch.cat(out).double().cpu()


def gap_readings(gaps: torch.Tensor, miss_gap: float) -> dict:
    """The widest and the mean gap, and ``miss_share``: the share of the
    served tokens whose gap is over ``miss_gap``: rare under the rounding
    of the stated precision, common under a coarser one."""
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean()),
            "miss_share": float((gaps > miss_gap).double().mean())}


# -------------------------------------------------------------- the run

def setup(conf: dict, tfc: dict, seed: int, device: str,
          quant: str = "none") -> dict:
    """Model, engine and driver of a run, warmed up."""
    from portbench import port
    serving = conf["serving"]
    cuda = device != "cpu"
    stages, t = {}, time.perf_counter()

    def stage(name):
        nonlocal t
        if cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        stages[name] = now - t
        t = now
    desc = modelgen.describe(conf, seed)
    params = modelgen.generate(desc, seed, device,
                               getattr(torch, serving["dtype"]))
    stage("weights")
    if cuda:
        port.prebuild()
    stage("kernel_builds")
    engine, report = port.make_engine(desc, params, serving, tfc, quant)
    stage("plans_and_engine")
    weight_bytes = torch.cuda.memory_allocated() if cuda else None
    plan = traffic_mod.clients(tfc, seed, desc["vocab"])
    driver = Driver(engine, plan, serving["max_burst"], cuda)
    stage("traffic")
    driver.warm(traffic_mod.warmup(tfc, serving, seed, desc["vocab"]),
                timeout=1200.0)
    stage("warm_up")
    return {"desc": desc, "params": params, "engine": engine,
            "report": report, "driver": driver, "weight_bytes": weight_bytes,
            "stages": stages, "traffic": tfc}


def window(state: dict, seconds: float, trace: bool) -> dict:
    """Drive the cell's load for ``seconds``; returns what the metric
    readers read (the check comes later)."""
    drv = state["driver"]
    t = time.perf_counter()
    drv.start(seconds, timeout=600.0)
    state["stages"]["first_wave"] = drv.t0 - t
    if trace:
        drv.slice_s = min(TRACE_MAX_S, seconds / 4)
        drv.trace_at = drv.t0 + TRACE_AT * seconds
    while time.perf_counter() < drv.t_end:
        if drv.error is not None:
            break
        time.sleep(min(0.05, max(0.0, drv.t_end - time.perf_counter())))
    peak = torch.cuda.max_memory_allocated() if drv.cuda else None
    drv.close(state["traffic"]["check"].get("drain_s", 0.0))
    recs = [r for r in drv.recs.values() if r.client is not None]
    done = [r for r in recs if r.fin is not None and r.done <= drv.t_end]
    checked = [r for r in recs
               if r.fin is not None and r.done <= drv.t_drained]
    sent = [r for r in recs if r.sent >= drv.t0]
    return {"t0": drv.t0, "t_end": drv.t_end, "seconds": seconds,
            "traffic": state["traffic"], "done": done,
            "finished": [r for r in done if r.sent >= drv.t0],
            "checked": checked,
            "attempted": len(sent),
            "failed": sum(r.rejected for r in recs),
            "window_tokens": drv.window_tokens,
            "calls": [c for c in drv.calls if drv.t0 <= c["t0"] < drv.t_end],
            "peak_bytes": peak, "trace": read_trace(drv) if trace else None}


def free_program(state: dict) -> None:
    """Drop the engine, its plans and pool, keeping the benchmark's own
    tensors for the reference."""
    state["driver"].engine = None
    state["driver"].result = None
    state["engine"] = None
    state["report"] = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(manifest: dict, cell: str, seed: int, seconds: float,
             trace: bool, device: str, t_start: float,
             conf: dict | None = None, tfc: dict | None = None,
             limits: dict | None = None) -> dict:
    """One run of ``cell``; returns the result line's object. ``conf``,
    ``tfc`` and ``limits`` default to the cell's files."""
    w, files = cell_files(manifest, cell)
    conf, tfc, limits = conf or files[0], tfc or files[1], limits or files[2]
    state = setup(conf, tfc, seed, device)
    ctx = window(state, seconds, trace)
    ctx.update({"desc": state["desc"], "cell": w,
                "serving": conf["serving"], "setup_s": ctx["t0"] - t_start,
                "weight_bytes": state["weight_bytes"]})
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in cell_entries(manifest, cell, kind):
        v = load_reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    print("set-up seconds: " + json.dumps(state["stages"]),
          file=sys.stderr)
    free_program(state)
    t = time.perf_counter()
    checks = check(state, ctx, conf, limits, seed)
    print(f"check seconds: {time.perf_counter() - t}", file=sys.stderr)
    correct = verdict(checks)
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": ctx["peak_bytes"]}
    out = {"correct": bool(correct and ctx["failed"] == 0),
           "attempted": ctx["attempted"], "failed": ctx["failed"],
           "metrics": metrics, "device": dev}
    tr = ctx["trace"]
    if trace and tr is not None:
        dev["busy_s"], dev["window_s"] = tr["busy_s"], tr["wall_s"]
        out["breakdown"] = {"device_ops": tr["device_ops"],
                            "idle_gaps": tr["idle_gaps"]}
    out["checks"] = checks
    return out


def check(state: dict, ctx: dict, conf: dict, limits: dict, seed: int,
          control: str | None = None, ref: list | None = None) -> dict:
    """The numbers compared, each with its limit, over the served tokens
    of a seeded sample of the requests finished in the window: how many
    tokens were compared, and those of the widest and the mean gap of
    their reference logits below the reference's best that the cell's
    check file gives a limit, and the share of tokens off by more than
    its ``miss_gap``. ``control`` (``"fp8"``) judges, in the
    program's place, the tokens the reference in that precision puts
    first; ``ref`` is the float32 reference's logits if already worked
    out for the same sample."""
    check_cfg = ctx["traffic"]["check"]
    picked = sample_finished(ctx["checked"], seed, check_cfg)
    in_window = sample_finished(ctx["done"], seed, check_cfg)
    print(f"check pool: {len(ctx['done'])} requests finished in the "
          f"window ({sum(len(r.fin.tokens) for r in in_window)} tokens "
          f"a sample of them alone would give), {len(ctx['checked'])} "
          f"by the drain's end; {len(picked)} compared", file=sys.stderr)
    out = {"served_tokens_compared": {
        "value": sum(len(r.fin.tokens) for r in picked),
        "limit": check_cfg["least_tokens"], "bound": "lower"}}
    got = {}
    if picked:
        args = (state["desc"], state["params"], conf["serving"], picked)
        ref = ref if ref is not None else reference_logits(*args)
        low = reference_logits(*args, quant=control) if control else None
        got = gap_readings(token_gaps(ref, picked, low),
                           limits.get("miss_gap", 0.0))
    for name in ("max_logit_gap", "mean_logit_gap", "miss_share"):
        if name in limits:
            out[name] = {"value": got.get(name, float("inf")),
                         "limit": limits[name], "bound": "upper"}
    return out


def verdict(checks: dict) -> bool:
    """Whether every number compared is within its limit."""
    return all(c["value"] <= c["limit"] if c["bound"] == "upper"
               else c["value"] >= c["limit"] for c in checks.values())


def print_checks(checks: dict) -> None:
    for name, c in checks.items():
        rel = "<=" if c["bound"] == "upper" else ">="
        print(f"check {name} {c['value']} {rel} limit {c['limit']}",
              file=sys.stderr)
