"""What the metric readers (``metrics/<name>.py``) share: the window's
request and call records, and the traced slice's device time against
the work it did.

``ctx`` is the run's record (``harness.window``): ``finished`` (the
client records of requests finished in the window), ``calls`` (the
engine's prefill chunks and decode bursts started in the window, each
with its host time and work), ``trace`` (the traced slice: its wall and
busy seconds, device seconds by kernel class, its calls and the port's
counters at both ends), ``desc`` (the model) and ``serving``.
"""
from __future__ import annotations

from portbench import roofline as R
from portbench import stats

GIB = float(1 << 30)
# the grouped kernel (k6) serves MoE calls of more tokens than this; the
# ragged kernel (k7) the rest (repro_torch/serve/sparse.py)
RAGGED_TOKENS_MAX = 64


def ms_p(values, q):
    values = [v * 1e3 for v in values]
    return stats.percentile(values, q) if values else None


def ttft(ctx):
    return [r.first - r.sent for r in ctx["finished"]]


def tpot(ctx):
    return [(r.last - r.first) / (r.n - 1) for r in ctx["finished"]
            if r.n > 1]


def decode_calls(ctx):
    return [c for c in ctx["calls"] if c["kind"] == "decode"]


def tick_ms(ctx):
    per = [(c["t1"] - c["t0"]) / c["ticks"] for c in decode_calls(ctx)]
    return stats.median(per) * 1e3 if per else None


def _bucket(n, serving):
    m = serving["prefill_multiple"]
    return -(-n // m) * m


def slice_calls(ctx):
    tr = ctx["trace"]
    return None if tr is None else tr["calls"]


def _counter(ctx, name):
    tr = ctx["trace"]
    return tr["counters1"].get(name, 0) - tr["counters0"].get(name, 0)


def kernel_share(ctx, cls, bound, kind):
    """Sum of bound seconds of the kernel's calls inside the traced
    slice's calls of ``kind`` (``"decode"`` or ``"prefill"``) over its
    device seconds there (the work between those calls' markers and the
    next); None where it did not run there or the markers do not
    attribute the work."""
    tr = ctx["trace"]
    if tr is None or not tr.get("by_kind_class_s"):
        return None
    dev = tr["by_kind_class_s"].get(kind, {}).get(cls, 0.0)
    if dev <= 0.0:
        return None
    b = bound(ctx, kind)
    return None if b is None else 100.0 * b / dev


def k1_bound(ctx, kind):
    """Kernel 1: every feed-forward projection of a dense model, once a
    decode tick over the active rows and once a prefill chunk over its
    real tokens, in the slice's calls of ``kind``."""
    desc = ctx["desc"]
    if desc["moe"] is not None:
        return None
    t = 0.0
    for c in slice_calls(ctx):
        if c["kind"] != kind:
            continue
        for rows in ([len(c["lens"])] * c["ticks"] if c["kind"] == "decode"
                     else [c["n"]]):
            for i in range(len(desc["layers"])):
                for name in ("gate", "up", "down"):
                    t += R.bound_s(*R.projection_call(desc, i, name, rows))
    return t


def k3_bound(ctx, kind):
    """Kernel 3: each layer's decode attention, once a tick, over the
    active sequences' cache lengths (it serves decode calls only)."""
    desc = ctx["desc"]
    if kind != "decode":
        return None
    t = 0.0
    for c in slice_calls(ctx):
        if c["kind"] != "decode":
            continue
        for lens in R.decode_ticks(c):
            for i in range(len(desc["layers"])):
                t += R.bound_s(*R.paged_attention_call(desc, i, lens))
    return t


def k6_bound(ctx, kind):
    """Kernel 6: each layer's three expert projections over a prefill
    chunk of more than ``RAGGED_TOKENS_MAX`` tokens (prefill calls only): the routed
    assignments (tokens x top-k) as rows, the live tiles of the experts
    the port's counter says were computed. None when the launches the
    port counted differ from the calls the slice logged."""
    desc, moe = ctx["desc"], ctx["desc"]["moe"]
    if moe is None or kind != "prefill":
        return None
    calls = [c for c in slice_calls(ctx) if c["kind"] == "prefill"
             and _bucket(c["n"], ctx["serving"]) > RAGGED_TOKENS_MAX]
    launches = _counter(ctx, "grouped_block_sparse")
    n_layers = len(desc["layers"])
    if not calls or launches != 3 * n_layers * len(calls):
        return None
    frac = _counter(ctx, "grouped_block_sparse_experts_computed") / (
        launches * moe["n_experts"])
    t = 0.0
    for c in calls:
        rows = c["n"] * moe["top_k"]
        for i in range(n_layers):
            for name in ("gate", "up", "down"):
                t += R.bound_s(*R.projection_call(
                    desc, i, name, rows, frac * moe["n_experts"]))
    return t


def step_bound(ctx):
    """The least time of all the slice's work: each decode tick and each
    prefill chunk as one whole forward (``roofline.step_call``). For an
    MoE, the share of experts computed is the port's counter over the
    launches of each path."""
    desc, moe = ctx["desc"], ctx["desc"]["moe"]
    fr = {"grouped": 1.0, "ragged": 1.0}
    if moe is not None:
        for path, launch, done in (
                ("grouped", "grouped_block_sparse",
                 "grouped_block_sparse_experts_computed"),
                ("ragged", "grouped_block_sparse_ragged",
                 "grouped_block_sparse_ragged_experts_computed")):
            n = _counter(ctx, launch)
            if n:
                fr[path] = _counter(ctx, done) / (n * moe["n_experts"])
    t = 0.0
    for c in slice_calls(ctx):
        if c["kind"] == "decode":
            for lens in R.decode_ticks(c):
                t += R.bound_s(*R.step_call(
                    desc, len(lens), sum(lens) - len(lens), len(lens),
                    sum(lens), fr["ragged"]))
        else:
            s, n = c["start"], c["n"]
            path = ("grouped" if _bucket(n, ctx["serving"])
                    > RAGGED_TOKENS_MAX else "ragged")
            t += R.bound_s(*R.step_call(desc, n, s, n,
                                        n * s + n * (n + 1) // 2, fr[path]))
    return t


def step_share(ctx):
    tr = ctx["trace"]
    if tr is None or not tr["calls"]:
        return None
    return 100.0 * step_bound(ctx) / tr["wall_s"]


def idle_share(ctx):
    tr = ctx["trace"]
    if tr is None or tr["busy_s"] <= 0.0:
        return None
    return 1.0 - tr["busy_s"] / tr["wall_s"]


def occupancy(ctx):
    calls = decode_calls(ctx)
    if not calls:
        return None
    return sum(len(c["lens"]) / c["slots"] for c in calls) / len(calls)


def prefill_p50_ms(ctx):
    return ms_p([r.fin.first_token_at - r.fin.admitted_at
                 for r in ctx["finished"]], 50)
