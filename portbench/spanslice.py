"""The span slice: two more stretches of a ``--trace 1`` run, with the
port's span log on, the first on one clock with the device trace.

The harness's traced slice (``harness.TRACE_AT``, half-way into the
window) keeps the span log off, so every metric it feeds reads as it
did. :class:`SpanSlice` gives a ``harness.Driver`` two stretches of the
same length, each started and stopped at decode calls as that slice is:

- the quiet stretch, from ``QUIET_AT`` of the window (ended before the
  harness's slice, whose profiler takes seconds to stop): the span log
  on, the profiler off. The span durations are read here, since the
  profiler slows every launch;
- the profiled stretch, from ``SPAN_AT`` of the window: ``torch.profiler``
  records CUDA activities only (kernels, copies and the runtime's launch
  records, with their correlation ids; no CPU ops, which would slow the
  host-bound path it measures), the program's span log
  (``repro_torch.serve.metrics.SPANS``) is on, and the driver's marker
  kernel before each call is stamped with the host time just before and
  just after its launch.

:func:`read` puts the profiled stretch on ``time.perf_counter_ns``: the
profiler's events are on its own unix-ns clock, and one
(``perf_counter_ns``, ``time_ns``) pair taken as the stretch opens
converts them. Device work goes to the span open at its launch record,
which the runtime stamps on the host (``device_by_span``), and each of
the device's idle gaps to the span that launched the work ending it
(``idle_by_span``); a gap's length is a difference of device times.
``clock_checks`` holds the launch records against the marker stamps,
and the device times, without the launch records, against the stamps
and the bursts' syncs.

On a program without the span log (``SPANS`` missing) the stretches
still run and every span metric reads None.

    python3 -m portbench.spanslice --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

runs a cell as ``run.py`` does, with these stretches in traced runs, and
prints the result with the span metrics (``SPAN_METRICS``, read by
``metrics/<name>.py``), the span breakdown, the per-call tick of each
stretch, and, in every run, the median ``decode_tick_ms`` of the window.
"""
import time

T_START = time.perf_counter()

import bisect  # noqa: E402

from portbench import roofline, stats  # noqa: E402

QUIET_AT = 0.2          # the quiet stretch starts here in the window
SPAN_AT = 0.75          # the profiled stretch three quarters in
CLOCK_TOL_US = 50.0     # how far a call's work may precede its span
# the per-layer metrics that read the span slice, as their entries in
# BENCHMARK.json's ``per_layer`` will read once the harness opens it
SPAN_METRICS = [
    {"name": name, "unit": unit, "better": "lower",
     "source": "device_trace" if layer == "device" else "program_span",
     "layer": layer, "moves": moves, "workloads": [cell]}
    for name, unit, layer, moves, cell in (
        ("tick_dispatch_ms.decode", "ms", "model step", "tokens_per_s",
         "phi3-decode"),
        ("attn_dispatch_us.decode", "us", "model step", "tokens_per_s",
         "phi3-decode"),
        ("ffn_dispatch_us.decode", "us", "model step", "tokens_per_s",
         "phi3-decode"),
        ("chunk_dispatch_ms.longprompt", "ms", "model step", "ttft_p50_ms",
         "phi3-longprompt"),
        ("dispatch_idle_share.decode", "share", "device", "tokens_per_s",
         "phi3-decode"))]
NO_SPAN = "(no span)"
NO_RECORD = "(no launch record)"


def _span_log():
    try:
        from repro_torch.serve.metrics import SPANS
    except ImportError:                 # a program without the span log
        return None
    return SPANS


class SpanSlice:
    """The two stretches' state, hooked into one driver's calls (they
    open in traced runs only): ``quiet`` the one without the profiler,
    ``rec`` the profiled one."""

    def __init__(self, drv):
        import torch
        self.drv = drv
        self.log = _span_log()
        self.on = False
        self.prof = None
        self.rec: dict = {}
        self.quiet: dict = {}
        self.marks: list = []           # (ns before, ns after) a marker
        start0, stop0, mark0 = drv._slice_start, drv._slice_stop, drv._mark

        def slice_start():
            start0()
            self._start()

        def slice_stop():
            stop0()
            self._stop()

        def mark():
            if not self.on:
                return mark0()
            t = time.perf_counter_ns()
            torch.cuda._sleep(1)
            self.marks.append((t, time.perf_counter_ns()))
        drv._slice_start, drv._slice_stop, drv._mark = (slice_start,
                                                        slice_stop, mark)

    def _past(self, share: float) -> bool:
        drv = self.drv
        return time.perf_counter() >= drv.t0 + share * (drv.t_end - drv.t0)

    def _start(self) -> None:
        drv = self.drv
        if (self.rec or drv.trace_at is None or drv.tracing
                or ("t0_ns" in self.quiet and "t1_ns" not in self.quiet)):
            return
        if (not self.quiet and self._past(QUIET_AT)
                and time.perf_counter() < drv.trace_at):
            self._open(self.quiet)
            return
        if not self._past(SPAN_AT):
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()
        # the first launch after the start is not recorded (seen on the
        # card): spend it on a kernel outside the slice
        torch.cuda._sleep(1)
        torch.cuda.synchronize()
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        self.rec["unix_minus_perf_ns"] = u - (a + b) // 2
        self.on = True
        self._open(self.rec)

    def _open(self, rec: dict) -> None:
        rec["first_call"] = len(self.drv.calls)
        if self.log is not None:
            self.log.enable()
        rec["t0_ns"] = time.perf_counter_ns()

    def _stop(self) -> None:
        rec = self.rec or self.quiet
        if ("t0_ns" not in rec or "t1_ns" in rec or time.perf_counter_ns()
                < rec["t0_ns"] + self.drv.slice_s * 1e9):
            return
        import torch
        torch.cuda.synchronize()
        rec["t1_ns"] = time.perf_counter_ns()
        if self.log is not None:
            self.log.disable()
        if rec is self.rec:
            t = time.perf_counter()
            self.prof.stop()
            rec["profiler_stop_s"] = time.perf_counter() - t
            self.on = False
        rec["end_call"] = len(self.drv.calls)
        rec["spans"] = self.log.drain() if self.log is not None else []
        rec["dropped"] = self.log.dropped if self.log is not None else 0


def _stretch(sl: SpanSlice, rec: dict) -> dict:
    return {"t0_ns": rec["t0_ns"], "t1_ns": rec["t1_ns"],
            "wall_s": (rec["t1_ns"] - rec["t0_ns"]) / 1e9,
            "spans": rec["spans"], "dropped": rec["dropped"],
            "calls": sl.drv.calls[rec["first_call"]:rec["end_call"]]}


def read(sl: SpanSlice) -> dict | None:
    """The profiled stretch on ``perf_counter_ns``: its wall, spans,
    device events (``(start, end, name, launch)`` sorted, ``launch`` the
    start of the runtime's launch record of the same correlation id, or
    None), marker stamps and the driver's calls inside it, with the
    quiet stretch's wall, spans and calls under ``quiet`` (None when it
    did not run to its end); None when the profiled stretch did not."""
    rec = sl.rec
    if "t1_ns" not in rec:
        return None
    from torch.autograd import DeviceType
    off = rec["unix_minus_perf_ns"]
    evs = list(sl.prof.profiler.kineto_results.events())
    launch = {e.correlation_id(): e.start_ns() - off for e in evs
              if e.device_type() == DeviceType.CPU
              and e.name().startswith("cu")}
    dev = [(e.start_ns() - off, e.end_ns() - off, e.name(),
            launch.get(e.correlation_id()))
           for e in evs if e.device_type() == DeviceType.CUDA]
    out = _stretch(sl, rec)
    out.update({"events": sorted(e for e in dev
                                 if e[3] is None or e[3] >= rec["t0_ns"]),
                "marks": list(sl.marks),
                "profiler_stop_s": rec["profiler_stop_s"],
                "quiet": (_stretch(sl, sl.quiet) if "t1_ns" in sl.quiet
                          else None)})
    return out


# ------------------------------------------------------------ analysis

def paths(spans: list) -> list:
    """Each span's path from its outermost ancestor, ``a/b/c``."""
    out: list = []
    for name, _, _, parent, _ in spans:
        out.append(name if parent < 0 else f"{out[parent]}/{name}")
    return out


def timeline(spans: list) -> list:
    """The host's time inside spans as ``(start, end, path)`` pieces,
    each piece in the innermost span open then, sorted by start."""
    kids: dict = {}
    for k, s in enumerate(spans):
        kids.setdefault(s[3], []).append(k)
    p = paths(spans)
    out = []
    for k, (_, t0, t1, _, _) in enumerate(spans):
        t = t0
        for j in sorted(kids.get(k, []), key=lambda j: spans[j][1]):
            if spans[j][1] > t:
                out.append((t, spans[j][1], p[k]))
            t = max(t, spans[j][2])
        if t1 > t:
            out.append((t, t1, p[k]))
    return sorted(out)


def path_at(tl: list, t: float) -> str:
    """The innermost span path open at host time ``t``."""
    i = bisect.bisect_right(tl, (t, float("inf"), "")) - 1
    return tl[i][2] if i >= 0 and tl[i][0] <= t < tl[i][1] else NO_SPAN


def work(tr: dict) -> list:
    return [e for e in tr["events"]
            if roofline.kernel_class(e[2]) != "marker"]


def gaps(tr: dict) -> list:
    """The device's idle intervals between the slice's work, each with
    the work that ends it: ``(start, end, event)``."""
    out, end = [], None
    for ev in work(tr):
        if end is not None and ev[0] > end:
            out.append((end, ev[0], ev))
        end = ev[1] if end is None else max(end, ev[1])
    return out


def launched_in(tl: list, ev: tuple) -> str:
    """The span path open at ``ev``'s launch record (``NO_RECORD``
    without one)."""
    return NO_RECORD if ev[3] is None else path_at(tl, ev[3])


def idle_by_span(tr: dict) -> dict:
    """Idle device seconds by the span that launched the work ending
    each gap."""
    tl = timeline(tr["spans"])
    out: dict = {}
    for g0, g1, ev in gaps(tr):
        p = launched_in(tl, ev)
        out[p] = out.get(p, 0.0) + (g1 - g0) / 1e9
    return out


def device_by_span(tr: dict) -> dict:
    """Device seconds of the slice's work by the span open at each
    kernel's launch."""
    tl = timeline(tr["spans"])
    out: dict = {}
    for ev in work(tr):
        p = launched_in(tl, ev)
        out[p] = out.get(p, 0.0) + (ev[1] - ev[0]) / 1e9
    return out


def calls_with_spans(tr: dict) -> list:
    """The slice's calls paired with their engine span (the n-th decode
    burst or prefill chunk span is the n-th such call)."""
    top = {"decode": "decode_burst", "prefill": "prefill_chunk"}
    spans = {k: [(j, s) for j, s in enumerate(tr["spans"])
                 if s[3] < 0 and s[0] == v] for k, v in top.items()}
    seen = {"decode": 0, "prefill": 0}
    out = []
    for c in tr["calls"]:
        i = seen[c["kind"]]
        seen[c["kind"]] += 1
        if i < len(spans[c["kind"]]):
            out.append((c, *spans[c["kind"]][i]))
    return out


def _least(values) -> float | None:
    return min(values, default=None)


def clock_checks(tr: dict) -> dict:
    """Whether the trace's clocks agree with the host's, in us (each
    reading must be >= 0 for its clock to hold).

    The launch records, which place work and gaps on spans: the least
    time from a marker's host stamp to its launch record
    (``launch_after_stamp_us``) and from the record to the host's return
    from the launch (``launch_before_return_us``).

    The device times, without the launch records: the least time from a
    marker's host stamp to its kernel's start (``marker_after_stamp_us``;
    a device clock running behind reads below 0) and from the end of the
    first device-to-host copy after a call's marker to the end of the
    call's sync, ``burst.sync`` or ``sample_first``
    (``sync_after_copy_us``; a device clock running ahead reads below
    0), each also at the slice's last call (``..._last_us``) and call by
    call (``..._each_us``); and, over
    every call, the least time from
    its span's start to the start of its work (the work between its
    marker and the next) plus the tolerance ``CLOCK_TOL_US``
    (``work_after_span_us``). A value is None where nothing was read."""
    marks = [e for e in tr["events"]
             if roofline.kernel_class(e[2]) == "marker"]
    out = {"markers": len(marks), "stamps": len(tr["marks"])}
    pairs = list(zip(marks, tr["marks"])) if len(marks) == len(
        tr["marks"]) else []
    launched = [(m, t) for m, t in pairs if m[3] is not None]
    out["launch_after_stamp_us"] = _least(
        (m[3] - t0) / 1e3 for m, (t0, _) in launched)
    out["launch_before_return_us"] = _least(
        (t1 - m[3]) / 1e3 for m, (_, t1) in launched)
    after = [(m[0] - t) / 1e3 for m, (t, _) in pairs]
    out["marker_after_stamp_us"] = _least(after)
    out["marker_after_stamp_last_us"] = after[-1] if after else None
    syncs, lead = [], None
    if pairs and len(pairs) == len(tr["calls"]):
        starts = [m[0] for m in marks]
        evs = tr["events"]
        t_ev = [e[0] for e in evs]
        ws = [e[0] for e in work(tr)]
        spans = {id(c): (j, s) for c, j, s in calls_with_spans(tr)}
        sync_end = {s[3]: s[2] for s in tr["spans"]
                    if s[0] in ("burst.sync", "sample_first")}
        for i, c in enumerate(tr["calls"]):
            if id(c) not in spans:
                continue
            j, span = spans[id(c)]
            end = starts[i + 1] if i + 1 < len(starts) else float("inf")
            k = bisect.bisect_left(ws, starts[i])
            if k < len(ws) and ws[k] < end:
                v = (ws[k] - span[1]) / 1e3 + CLOCK_TOL_US
                lead = v if lead is None else min(lead, v)
            if j not in sync_end:
                continue
            k = bisect.bisect_left(t_ev, starts[i])
            copy = next((e for e in evs[k:] if e[0] < end
                         and "DtoH" in e[2]), None)
            if copy is not None:
                syncs.append((sync_end[j] - copy[1]) / 1e3)
    out["sync_after_copy_us"] = _least(syncs)
    out["sync_after_copy_last_us"] = syncs[-1] if syncs else None
    out["work_after_span_us"] = lead
    out["marker_after_stamp_each_us"] = after
    out["sync_after_copy_each_us"] = syncs
    return out


def span_cover(tr: dict) -> float | None:
    """The share of the idle seconds ended by work launched inside the
    slice's calls (their host intervals, by the driver's clock) that a
    named span launched."""
    calls = sorted((c["t0"] * 1e9, c["t1"] * 1e9) for c in tr["calls"])
    starts = [c[0] for c in calls]
    tl = timeline(tr["spans"])
    inside = named = 0.0
    for g0, g1, ev in gaps(tr):
        if ev[3] is None:
            continue
        i = bisect.bisect_right(starts, ev[3]) - 1
        if i >= 0 and ev[3] < calls[i][1]:
            inside += g1 - g0
            named += (g1 - g0) if path_at(tl, ev[3]) != NO_SPAN else 0.0
    return named / inside if inside else None


def durations(spans: list, name: str, under: str | None = None) -> list:
    """Durations (ns) of the spans named ``name``, with an ancestor
    named ``under`` when given."""
    ps = paths(spans)
    return [s[2] - s[1] for s, p in zip(spans, ps)
            if s[0] == name and (under is None
                                 or under in p.split("/")[:-1])]


def span_trace(ctx):
    tr = ctx.get("span_trace")
    return tr if tr and tr["spans"] else None


def quiet_spans(ctx) -> list:
    """The quiet stretch's spans (none where it did not run)."""
    tr = ctx.get("span_trace")
    return (tr.get("quiet") or {}).get("spans") or [] if tr else []


def median_span(ctx, name, under, scale):
    """Median duration of the quiet stretch's ``name`` spans (under
    ``under``), ns over ``scale``."""
    d = durations(quiet_spans(ctx), name, under)
    return stats.median(d) / scale if d else None


def chunk_dispatch_ms(ctx):
    """Median over the quiet stretch's prefill chunks of the chunk's span
    less its ``sample_first`` child (which holds the chunk's sync), ms."""
    sp = quiet_spans(ctx)
    firsts: dict = {}
    for s in sp:
        if s[0] == "sample_first" and s[3] >= 0:
            firsts[s[3]] = firsts.get(s[3], 0) + s[2] - s[1]
    d = [s[2] - s[1] - firsts.get(k, 0) for k, s in enumerate(sp)
         if s[0] == "prefill_chunk"]
    return stats.median(d) / 1e6 if d else None


def dispatch_idle_share(ctx):
    """Idle device seconds of the profiled stretch whose gap ends in
    work launched inside a ``tick`` span, over the stretch's wall."""
    tr = span_trace(ctx)
    if tr is None:
        return None
    idle = sum(v for p, v in idle_by_span(tr).items()
               if "tick" in p.split("/"))
    return idle / tr["wall_s"]


def top(d: dict, n: int = 10) -> list:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


def breakdown(ctx) -> dict:
    """The span slice's additions to a traced run's ``breakdown``: the
    top ten paths by idle seconds (``idle_gaps_by_span``), by device
    seconds launched in them and by host self seconds, and the clock
    checks (``span_clock``)."""
    d = detail(ctx)
    if not d:
        return {}
    return {"idle_gaps_by_span": top(d["idle_by_span"]),
            "device_by_span": top(d["device_by_span"]),
            "host_by_span": top(d["host_by_span"]),
            "span_clock": [[k, v] for k, v in d["clock"].items()
                           if not isinstance(v, list)]}


def _by_path(spans: list) -> dict:
    out: dict = {}
    for s, p in zip(spans, paths(spans)):
        out.setdefault(p, []).append((s[2] - s[1]) / 1e3)
    return {p: [len(v), stats.median(v)] for p, v in out.items()}


def _from(ctx, stretch) -> float | None:
    """Seconds from the window's start to the stretch's."""
    if not stretch or "t0" not in ctx:
        return None
    return stretch["t0_ns"] / 1e9 - ctx["t0"]


def detail(ctx) -> dict:
    """The profiled stretch's idle, device and host self seconds by
    path; each stretch's spans' count and median duration (us) by path;
    the clock checks with the share of idle in calls under a named span,
    the spans dropped, the seconds the profiler took to stop, when each
    stretch began in the window, and the median tick (ms, by the driver's call
    times) of each stretch, of the harness's slice and of the window's
    other calls."""
    tr = span_trace(ctx)
    if tr is None:
        return {}
    host: dict = {}
    for a, b, p in timeline(tr["spans"]):
        host[p] = host.get(p, 0.0) + (b - a) / 1e9
    quiet = tr.get("quiet") or {"calls": [], "spans": [], "dropped": 0}
    first = ctx["trace"]["calls"] if ctx.get("trace") else []
    sliced = {id(c) for c in tr["calls"] + quiet["calls"] + first}
    clock = clock_checks(tr)
    clock.update({"span_cover": span_cover(tr),
                  "profiler_stop_s": tr.get("profiler_stop_s"),
                  "profiled_from_s": _from(ctx, tr),
                  "quiet_from_s": _from(ctx, tr.get("quiet")),
                  "dropped": tr["dropped"] + quiet["dropped"],
                  "tick_ms_slice": slice_tick_ms(tr["calls"]),
                  "tick_ms_quiet": slice_tick_ms(quiet["calls"]),
                  "tick_ms_first_slice": slice_tick_ms(first),
                  "tick_ms_rest": slice_tick_ms(
                      [c for c in ctx.get("calls", [])
                       if id(c) not in sliced])})
    return {"idle_by_span": idle_by_span(tr),
            "device_by_span": device_by_span(tr), "host_by_span": host,
            "spans_by_path": _by_path(tr["spans"]),
            "quiet_spans_by_path": _by_path(quiet["spans"]),
            "clock": clock, "wall_s": tr["wall_s"]}


def slice_tick_ms(calls: list):
    per = [(c["t1"] - c["t0"]) / c["ticks"] for c in calls
           if c["kind"] == "decode"]
    return stats.median(per) * 1e3 if per else None


# ------------------------------------------------------------------ run

def run(manifest: dict, cell: str, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, **kw) -> tuple:
    """``harness.run_cell`` with the span slice attached in traced runs:
    the span metrics join the cell's per-layer metrics, the span
    breakdown its ``breakdown``, and ``decode_tick_ms`` (the window's
    median, every run) is its own key. Returns the result and the run's
    record (``ctx``)."""
    from portbench import harness, readers
    got: dict = {}
    window0 = harness.window

    def window(state, seconds, trace):
        sl = SpanSlice(state["driver"]) if trace else None
        ctx = window0(state, seconds, trace)
        ctx["span_trace"] = read(sl) if sl is not None else None
        got["ctx"] = ctx
        return ctx
    mf = dict(manifest, per_layer=manifest["per_layer"] + SPAN_METRICS)
    harness.window = window
    try:
        out = harness.run_cell(mf, cell, seed, seconds, trace, device,
                               t_start, **kw)
    finally:
        harness.window = window0
    if trace and "breakdown" in out:
        out["breakdown"].update(breakdown(got["ctx"]))
    out["decode_tick_ms"] = readers.tick_ms(got["ctx"])
    return out, got["ctx"]


def main() -> int:
    import argparse
    import json
    import sys
    from pathlib import Path

    from portbench import run as run_mod
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", help="write the span slice's whole detail "
                    "here (JSON)")
    args = ap.parse_args()
    run_mod.environment()
    manifest = json.loads((run_mod.ROOT / "BENCHMARK.json").read_text())
    import torch
    if not torch.cuda.is_available():
        print("the span slice needs a CUDA card", file=sys.stderr)
        return 3
    from portbench import harness
    out, ctx = run(manifest, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(detail(ctx)))
    harness.print_checks(out["checks"])
    sys.stderr.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
