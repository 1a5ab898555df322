"""The port's span log (``common/spans.py``, re-exported by
``serve/metrics.py``) over the continuous engine.

Off by default, the log records nothing from a whole run. On, a tiny
paged run gives the tree the serving path promises: decode bursts of
prep, ticks, one sync and a commit; each tick an embed, one block per
layer (each an ``attn`` and an ``ffn``), a head and a sample; prefill
chunks carrying their request's uid; every child inside its parent.
Served tokens are the same with the log on and off, greedy, on either
pool: the spans add, reorder and synchronise nothing.
"""
import pytest
import torch

from repro_torch.models import transformer as T
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MLPSpec,
                                      ModelConfig)
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.metrics import SPANS, SpanLog
from repro_torch.serve.scheduler import Request
from repro_torch.serve.sparse import pack_model

N_LAYERS = 3
PAGED = dict(block_size=8, prefill_chunk=16)


@pytest.fixture(scope="module")
def model():
    cfg = ModelConfig(name="trace", d_model=64, vocab=256,
                      vocab_pad_multiple=16,
                      pattern=(LayerSpec(AttentionSpec(n_q=4, n_kv=2,
                                                       head_dim=16),
                                         MLPSpec(d_ff=128)),),
                      n_periods=N_LAYERS, scan_layers=False, remat=False)
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    return params, cfg, pack_model(params, cfg, block=16)


def requests():
    g = torch.Generator().manual_seed(1)
    lens = [5, 23, 40, 12]
    return [Request(uid=i, prompt=torch.randint(1, 256, (n,),
                                                generator=g).tolist(),
                    max_new_tokens=6 + 3 * i) for i, n in enumerate(lens)]


def serve(model, pool: dict, traced: bool):
    params, cfg, packed = model
    eng = ContinuousEngine(params, cfg, ServeConfig(
        max_slots=2, max_seq=64, prefill_multiple=8,
        compute_dtype=torch.float32, cache_dtype=torch.float32, **pool),
        packed=packed)
    if traced:
        SPANS.enable()
    try:
        finished, _ = eng.run(requests(), max_burst=4)
    finally:
        SPANS.disable()
    return [f.tokens for f in finished], SPANS.drain()


def children(spans, k):
    return [j for j, s in enumerate(spans) if s[3] == k]


def test_log_off_records_nothing(model):
    SPANS.enable()
    SPANS.disable()
    tokens, spans = serve(model, PAGED, traced=False)
    assert spans == [] and SPANS.n == 0 and tokens


def test_paged_run_gives_the_span_tree(model):
    _, spans = serve(model, PAGED, traced=True)
    assert spans and SPANS.dropped == 0
    for name, t0, t1, parent, _ in spans:
        assert 0 < t0 <= t1, name
        if parent >= 0:
            p = spans[parent]
            assert p[1] <= t0 and t1 <= p[2], (name, p[0])
    names = [s[0] for s in spans]
    tops = {s[0] for s in spans if s[3] < 0}
    assert tops == {"admit", "cow_guard", "prefill_chunk", "decode_burst"}
    bursts = [k for k, s in enumerate(spans) if s[0] == "decode_burst"]
    assert bursts
    for k in bursts:
        kids = [spans[j][0] for j in children(spans, k)]
        attrs = spans[k][4]
        assert kids == (["burst.prep"] + ["tick"] * attrs["ticks"]
                        + ["burst.sync", "burst.commit"])
        assert attrs["slots"] == 2 and 1 <= attrs["rows"] <= 2
    ticks = [k for k, s in enumerate(spans) if s[0] == "tick"]
    assert len(ticks) == sum(spans[k][4]["ticks"] for k in bursts)
    for k in ticks:
        kids = children(spans, k)
        assert [spans[j][0] for j in kids] == (
            ["embed"] + ["block"] * N_LAYERS + ["head", "sample"])
        layers = [spans[j][4]["layer"] for j in kids
                  if spans[j][0] == "block"]
        assert layers == list(range(N_LAYERS))
    for k in (k for k, n in enumerate(names) if n == "block"):
        assert [spans[j][0] for j in children(spans, k)] == ["attn", "ffn"]
    chunks = [s for s in spans if s[0] == "prefill_chunk"]
    by_uid: dict = {}
    for c in chunks:
        by_uid.setdefault(c[4]["uid"], []).append(c[4])
    prompts = {r.uid: len(r.prompt) for r in requests()}
    assert set(by_uid) == set(prompts)
    for uid, cs in by_uid.items():
        assert [c["start"] for c in cs] == list(range(0, prompts[uid], 16))
        assert sum(c["n"] for c in cs) == prompts[uid]
    for k in (k for k, n in enumerate(names) if n == "prefill_chunk"):
        kids = [spans[j][0] for j in children(spans, k)]
        last = spans[k][4]["start"] + spans[k][4]["n"] == prompts[
            spans[k][4]["uid"]]
        assert kids == (["chunk.prep", "embed"] + ["block"] * N_LAYERS
                        + ["head"] + (["sample_first"] if last else []))


@pytest.mark.parametrize("pool", [PAGED, {}], ids=["paged", "contiguous"])
def test_served_tokens_equal_with_the_log_on(model, pool):
    off, _ = serve(model, pool, traced=False)
    on, spans = serve(model, pool, traced=True)
    assert on == off
    assert sum(s[0] == "prefill_chunk" for s in spans) >= len(off)


def test_log_bounds_and_drain():
    log = SpanLog(capacity=3)
    log.enable()
    a = log.open("a", x=1)
    log.open("b", y=2)
    log.close(a)                        # closes the child left open too
    assert log.open("c") == 2 and log.open("d") == -1 and log.dropped == 1
    log.close(2)
    out = log.drain()
    assert [(r[0], r[3], r[4]) for r in out] == [
        ("a", -1, {"x": 1}), ("b", 0, {"y": 2}), ("c", -1, {})]
    assert out[1][2] == out[0][2] and log.drain() == []
    log.open("e")
    with pytest.raises(RuntimeError):
        log.drain()
