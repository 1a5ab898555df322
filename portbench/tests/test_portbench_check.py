"""The check that decides ``correct``, driven through the rest of a run
on the CPU at a tiny size: the float32 reference agrees with the port's
served tokens; each fault a serving cell can have, planted under the
timed path, comes out not correct; and the controls read above the
sound program. (A one-card cell has no exchange between chips to leave
out.)"""
import json
import time

import pytest
import torch

from portbench import harness, port
from portbench.tests import tiny

MANIFEST = json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())
# the cell whose entry a run takes: the MoE stand-in runs under the
# longprompt cell's entry with its own configuration
CELLS = {"dense": "phi3-decode", "moe": "phi3-longprompt"}
# f32 serving at this size agrees with the reference to ~1e-5
LIMIT = {"max_logit_gap": 1e-3, "mean_logit_gap": 1e-4, "miss_share": 0.0,
         "miss_gap": 1e-3}


def conf32(kind):
    c = tiny.conf(kind)
    c["serving"]["dtype"] = "float32"
    return c


def run(kind, seed=11, seconds=2.0):
    return harness.run_cell(MANIFEST, CELLS[kind], seed, seconds, False,
                            "cpu", time.perf_counter(), conf=conf32(kind),
                            tfc=tiny.traffic(), limits=LIMIT)


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_reference_agrees_with_the_served_tokens(kind):
    out = run(kind)
    assert out["correct"], out["checks"]
    assert out["checks"]["max_logit_gap"]["value"] < 1e-4
    assert out["checks"]["served_tokens_compared"]["value"] >= 20
    assert list(out["checks"]) == ["served_tokens_compared",
                                   "max_logit_gap", "mean_logit_gap",
                                   "miss_share"]


def test_the_drain_gives_the_check_every_request_in_flight():
    """With ``drain_s`` the requests in flight at the window's close
    finish their whole budgets after it, for the check alone: none is
    cut, the metrics' requests stay those done by the window's end, and
    the finished set holds one more request per client."""
    t = tiny.traffic(check=dict(tiny.traffic()["check"], drain_s=60))
    state = harness.setup(conf32("dense"), t, 7, "cpu")
    ctx = harness.window(state, 1.0, False)
    harness.free_program(state)
    late = [r for r in ctx["checked"] if r.done > ctx["t_end"]]
    assert all(r.done <= ctx["t_end"] for r in ctx["done"])
    assert len(ctx["checked"]) == len(ctx["done"]) + len(late)
    assert len(late) == t["clients"]
    assert all(len(r.fin.tokens) == r.req.max_new_tokens > 1
               for r in late)


def test_gap_readings_count_misses_over_the_gap():
    g = torch.tensor([0.0, 0.0, 0.01, 0.06, 0.2, 0.0, 0.0, 0.05],
                     dtype=torch.float64)
    got = harness.gap_readings(g, 0.05)
    assert got["max_logit_gap"] == pytest.approx(0.2)
    assert got["mean_logit_gap"] == pytest.approx(0.32 / 8)
    assert got["miss_share"] == pytest.approx(2 / 8)     # 0.05 is no miss
    checks = {"a": {"value": 0.25, "limit": 0.2, "bound": "upper"},
              "b": {"value": 10, "limit": 4, "bound": "lower"}}
    assert not harness.verdict(checks)
    checks["a"]["value"] = 0.2
    assert harness.verdict(checks)


def altered_token(mp):
    from repro_torch.serve import batching
    sample = batching.sample_tokens

    def wrong(logits, *a, **k):
        return (sample(logits, *a, **k) + 1) % 500
    mp.setattr(batching, "sample_tokens", wrong)


def state_unchanged(mp):
    from repro_torch.models import layers
    mp.setattr(layers, "paged_write", lambda cache_kv, *a, **k: cache_kv)


def half_batch(mp):
    make = port.make_engine

    def broken(*a, **k):
        engine, report = make(*a, **k)
        step = engine._decode

        def decode(*args):
            logits, pool = step(*args)
            h = logits.shape[0] // 2
            logits = logits.clone()
            logits[h:] = logits[:h].mean(0)
            return logits, pool
        engine._decode = decode
        return engine, report
    mp.setattr(port, "make_engine", broken)


@pytest.mark.parametrize("fault", [altered_token, state_unchanged,
                                   half_batch])
def test_each_fault_comes_out_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    out = run("dense")
    assert not out["correct"]
    assert out["checks"]["max_logit_gap"]["value"] > LIMIT["max_logit_gap"]


@pytest.mark.parametrize("kind", ["dense", "moe"])
def test_controls_read_above_the_sound_program(kind):
    """The sound program comes out correct through ``harness.check``; the
    fp8 reference in its place does not, nor do the port's own int8 tiles
    on the dense model. (On the MoE, int8 expert tiles move no served
    token here, as they move none beyond the sound program's spread on
    the card: no benchmark cell serves the MoE.)"""
    c, t = conf32(kind), tiny.traffic()
    verdicts, readings = {}, {}
    for quant in ("none", "int8"):
        state = harness.setup(c, t, 5, "cpu", quant=quant)
        ctx = harness.window(state, 2.0, False)
        harness.free_program(state)
        runs = {quant: {}} if quant == "int8" else {"none": {},
                                                    "fp8": {"control": "fp8"}}
        for name, kw in runs.items():
            got = harness.check(state, ctx, c, LIMIT, 5, **kw)
            verdicts[name] = harness.verdict(got)
            readings[name] = got["max_logit_gap"]["value"]
    want = {"none": True, "fp8": False}
    if kind == "dense":
        want["int8"] = False
    assert {k: verdicts[k] for k in want} == want, readings
    assert readings["fp8"] > 3 * readings["none"]


@pytest.mark.gpu
def test_the_gpu_path_runs_a_tiny_cell(cuda):
    """On a card: the kernels' path of a tiny cell, end to end."""
    out = harness.run_cell(MANIFEST, "phi3-decode", 3, 2.0, False, cuda,
                           time.perf_counter(), conf=conf32("dense"),
                           tfc=tiny.traffic(), limits=LIMIT)
    assert out["correct"], out["checks"]
    assert torch.cuda.max_memory_allocated() > 0
