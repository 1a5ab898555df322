"""The span slice's readers (``spanslice.py``, ``metrics/*dispatch*``) on
a synthetic slice worked by hand: idle gaps and kernels by the span that
launched them, the clock checks; the two stretches a driver gets; each
reader's None without spans; and a run through ``spanslice.run`` on the
CPU (untraced: no slice, the window's tick)."""
import json
import time

import pytest
import torch

from portbench import harness, spanslice
from portbench.tests import tiny

READERS = [m["name"] for m in spanslice.SPAN_METRICS]
SPANS = [                                   # name, t0, t1, parent, attrs
    ("decode_burst", 100, 1000, -1, {"rows": 2, "ticks": 1, "slots": 4}),
    ("burst.prep", 110, 200, 0, {}),
    ("tick", 200, 800, 0, {}),
    ("block", 300, 700, 2, {"layer": 0}),
    ("attn", 300, 500, 3, {}),
    ("ffn", 500, 700, 3, {}),
    ("burst.sync", 800, 950, 0, {}),
    ("prefill_chunk", 1100, 1600, -1, {"uid": 3, "start": 0, "n": 16}),
    ("chunk.prep", 1100, 1150, 7, {}),
    ("sample_first", 1500, 1580, 7, {}),
]
# the quiet stretch: the same tree at twice the durations
QUIET = [(n, 2 * t0, 2 * t1, p, a) for n, t0, t1, p, a in SPANS]
MARK = "void at::cuda::(anonymous namespace)::spin_kernel(long)"
EVENTS = [                                  # start, end, name, launch
    (90, 91, MARK, 80), (190, 210, "Memcpy HtoD", 180),
    (320, 400, "k_a", 310), (450, 460, "k_b", 440), (600, 650, "k_c", 590),
    (720, 790, "k_d", 710), (930, 940, "Memcpy DtoH", 805),
    (1085, 1086, MARK, 1070), (1096, 1098, "k_z", 1095),
    (1200, 1400, "k_p", 1160), (1450, 1460, "k_q", None),
    (1520, 1530, "Memcpy DtoH", 1505)]
CALLS = [{"kind": "decode", "t0": 95e-9, "t1": 1000e-9, "ticks": 1},
         {"kind": "prefill", "t0": 1090e-9, "t1": 1600e-9}]
QUIET_CALLS = [{"kind": "decode", "t0": 2000e-9, "t1": 4000e-9, "ticks": 2}]


def trace(**kw):
    tr = {"t0_ns": 50, "t1_ns": 1650, "wall_s": 1600e-9, "spans": SPANS,
          "dropped": 0, "events": EVENTS, "marks": [(70, 85), (1060, 1080)],
          "calls": CALLS,
          "quiet": {"t0_ns": 2000, "spans": QUIET, "dropped": 1,
                    "calls": QUIET_CALLS}}
    tr.update(kw)
    return tr


def shifted(dt):
    """The worked slice on a device clock ``dt`` ns ahead."""
    return trace(events=[(s + dt, e + dt, n, launch)
                         for s, e, n, launch in EVENTS])


def test_idle_gaps_split_by_the_host_span():
    """Each gap goes to the span open at the launch record of the work
    that ends it, at its length on the device's clock."""
    got = spanslice.idle_by_span(trace())
    want = {"decode_burst/tick/block/attn": 160,
            "decode_burst/tick/block/ffn": 140, "decode_burst/tick": 70,
            "decode_burst/burst.sync": 140, spanslice.NO_SPAN: 156,
            "prefill_chunk": 102, spanslice.NO_RECORD: 50,
            "prefill_chunk/sample_first": 60}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    assert spanslice.span_cover(trace()) == pytest.approx(672 / 828)
    assert spanslice.idle_by_span(shifted(-40)) == pytest.approx(got)


def test_kernels_go_to_the_span_that_launched_them():
    got = spanslice.device_by_span(trace())
    want = {"decode_burst/burst.prep": 20,
            "decode_burst/tick/block/attn": 90,
            "decode_burst/tick/block/ffn": 50, "decode_burst/tick": 70,
            "decode_burst/burst.sync": 10, spanslice.NO_SPAN: 2,
            "prefill_chunk": 200, spanslice.NO_RECORD: 10,
            "prefill_chunk/sample_first": 10}
    assert got == pytest.approx({k: v / 1e9 for k, v in want.items()})
    no_records = [(s, e, n, None) for s, e, n, _ in EVENTS]
    assert spanslice.device_by_span(trace(events=no_records)) == \
        pytest.approx({spanslice.NO_RECORD: 462e-9})


def test_clock_checks():
    got = spanslice.clock_checks(trace())
    assert got["markers"] == got["stamps"] == 2
    assert got["launch_after_stamp_us"] == pytest.approx(0.01)
    assert got["launch_before_return_us"] == pytest.approx(0.005)
    assert got["marker_after_stamp_us"] == pytest.approx(0.02)
    assert got["marker_after_stamp_last_us"] == pytest.approx(0.025)
    assert got["sync_after_copy_us"] == pytest.approx(0.01)
    assert got["sync_after_copy_last_us"] == pytest.approx(0.05)
    assert got["work_after_span_us"] == pytest.approx(
        -0.004 + spanslice.CLOCK_TOL_US)
    # the device times against the host's, without the launch records: a
    # device clock ahead fails the syncs, one behind the markers
    ahead, behind = (spanslice.clock_checks(shifted(dt)) for dt in (60, -30))
    assert ahead["sync_after_copy_us"] == pytest.approx(-0.05)
    assert ahead["marker_after_stamp_us"] == pytest.approx(0.08)
    assert behind["marker_after_stamp_us"] == pytest.approx(-0.01)
    assert behind["sync_after_copy_us"] == pytest.approx(0.04)
    assert ahead["launch_after_stamp_us"] == pytest.approx(0.01)
    early = trace(spans=[
        (n, t0 + 200_000 if k == 0 else t0, t1 + 200_000 if k == 0 else t1,
         p, a) for k, (n, t0, t1, p, a) in enumerate(SPANS)])
    assert spanslice.clock_checks(early)["work_after_span_us"] < 0
    lost = spanslice.clock_checks(trace(marks=[(70, 85)]))
    assert lost["marker_after_stamp_us"] is None
    assert lost["work_after_span_us"] is None
    assert lost["sync_after_copy_us"] is None


class FakeDriver:
    """A ``harness.Driver``'s hooks and clock as the span slice uses
    them."""

    def __init__(self, slice_s):
        self.at(0.0)
        self.trace_at, self.tracing, self.slice_s = None, False, slice_s
        self.calls, self.marked = [], 0
        self._slice_start = self._slice_stop = lambda: None

    def at(self, share, window_s=1000.0):
        """Put the clock ``share`` of the way into the window (the
        harness's slice, in a traced run, half-way)."""
        self.t0 = time.perf_counter() - share * window_s
        self.t_end = self.t0 + window_s
        if getattr(self, "trace_at", None) is not None:
            self.trace_at = self.t0 + window_s / 2

    def _mark(self):
        self.marked += 1

    def call(self, log):
        self._slice_start()
        self._mark()
        k = log.open("decode_burst") if log.on else -1
        self.calls.append({"kind": "decode"})
        if k >= 0:
            log.close(k)
        self._slice_stop()


class FakeProfile:
    def __init__(self, activities):
        self.running = False

    def start(self):
        self.running = True

    def stop(self):
        self.running = False


def test_the_stretches_run_quiet_then_profiled(monkeypatch):
    """Past ``QUIET_AT`` and before the harness's slice the first call
    opens the quiet stretch (the span log alone); past ``SPAN_AT`` the
    profiled one (the profiler, the span log and stamped markers on);
    each lasts ``slice_s`` and keeps its own calls and spans, and the
    log is off after."""
    from repro_torch.serve.metrics import SPANS
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.cuda, "_sleep", lambda n: None)
    monkeypatch.setattr("torch.profiler.profile", FakeProfile)
    drv = FakeDriver(slice_s=0.0)
    sl = spanslice.SpanSlice(drv)
    drv.call(SPANS)                                 # an untraced run
    drv.trace_at = 0.0                              # a traced run
    drv.at(0.0)
    drv.call(SPANS)
    assert not sl.quiet and not sl.rec              # before QUIET_AT
    drv.at(spanslice.QUIET_AT + 0.01)
    drv.call(SPANS)
    drv.call(SPANS)
    drv.at(spanslice.SPAN_AT + 0.01)
    drv.call(SPANS)
    drv.call(SPANS)
    assert not SPANS.on and not sl.on
    assert [sl.quiet["first_call"], sl.quiet["end_call"]] == [2, 3]
    assert [sl.rec["first_call"], sl.rec["end_call"]] == [4, 5]
    assert [s[0] for s in sl.quiet["spans"]] == ["decode_burst"]
    assert [s[0] for s in sl.rec["spans"]] == ["decode_burst"]
    assert len(sl.marks) == 1 and drv.marked == 5
    assert not sl.prof.running and sl.rec["profiler_stop_s"] >= 0


def test_readers_on_the_worked_slice():
    """The durations come from the quiet stretch, the idle share from
    the profiled one."""
    ctx = {"span_trace": trace(), "trace": {"calls": CALLS[:1]}, "t0": 0.0,
           "calls": CALLS + QUIET_CALLS + [
               {"kind": "decode", "t0": 0.0, "t1": 3e-6, "ticks": 1}]}
    got = {n: harness.load_reader(n)(ctx) for n in READERS}
    assert got == pytest.approx({
        "tick_dispatch_ms.decode": 1200e-6, "attn_dispatch_us.decode": 0.4,
        "ffn_dispatch_us.decode": 0.4,
        "chunk_dispatch_ms.longprompt": 840e-6,
        "dispatch_idle_share.decode": 370 / 1600})
    bd = spanslice.breakdown(ctx)
    assert bd["idle_gaps_by_span"][0] == [
        "decode_burst/tick/block/attn", pytest.approx(160e-9)]
    clock = dict(bd["span_clock"])
    assert clock["tick_ms_slice"] == pytest.approx(905e-9 * 1e3)
    assert clock["tick_ms_quiet"] == pytest.approx(1000e-9 * 1e3)
    assert clock["tick_ms_first_slice"] == pytest.approx(905e-9 * 1e3)
    assert clock["tick_ms_rest"] == pytest.approx(3e-6 * 1e3)
    assert clock["span_cover"] == pytest.approx(672 / 828)
    assert clock["dropped"] == 1
    assert clock["profiled_from_s"] == pytest.approx(50e-9)
    assert clock["quiet_from_s"] == pytest.approx(2000e-9)
    assert "marker_after_stamp_each_us" not in clock
    d = spanslice.detail(ctx)
    assert d["spans_by_path"]["decode_burst/tick/block"] == [1, 0.4]
    assert d["quiet_spans_by_path"]["decode_burst/tick/block"] == [1, 0.8]
    assert sum(d["host_by_span"].values()) == pytest.approx(1400e-9)
    assert d["clock"]["sync_after_copy_each_us"] == pytest.approx(
        [0.01, 0.05])
    # no quiet stretch: the durations read None, the idle share a number
    ctx["span_trace"] = trace(quiet=None)
    got = {n: harness.load_reader(n)(ctx) for n in READERS}
    assert got["dispatch_idle_share.decode"] == pytest.approx(370 / 1600)
    assert [n for n, v in got.items() if v is None] == READERS[:4]


@pytest.mark.parametrize("name", READERS)
def test_readers_read_none_without_spans(name):
    read = harness.load_reader(name)
    assert read({"span_trace": None}) is None
    assert read({}) is None
    no_log = trace(spans=[], quiet={"spans": [], "dropped": 0,
                                    "calls": []})
    assert read({"span_trace": no_log}) is None             # no span log
    assert spanslice.breakdown({"span_trace": None}) == {}


def test_the_tool_runs_a_cell_untraced_on_the_cpu():
    manifest = json.loads((harness.HERE.parent / "BENCHMARK.json")
                          .read_text())
    c = tiny.conf("dense")
    c["serving"]["dtype"] = "float32"
    window = harness.window
    out, ctx = spanslice.run(manifest, "phi3-decode", 5, 2.0, False, "cpu",
                        time.perf_counter(), conf=c, tfc=tiny.traffic(),
                        limits={"max_logit_gap": 1e-3})
    assert out["correct"] and out["decode_tick_ms"] > 0
    assert "breakdown" not in out and harness.window is window
    assert not set(READERS) & set(out["metrics"])
    assert ctx["span_trace"] is None and spanslice.detail(ctx) == {}
