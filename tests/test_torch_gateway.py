"""The port's gateway front door, ported from ``tests/test_gateway.py``:
wire-schema validation, EngineBridge streaming token identity against
driving the engine directly (contiguous and paged with a shared prefix,
greedy and sampled with the port's counter-based sampler), the HTTP
surface (ndjson streaming, /metrics, /healthz, 400s), structured reject
reasons on the response path, engine crashes, and placement sizing.

Two checks cross the packages on a JAX-written bundle: ``plan_placement``
gives the same ``Placement.to_dict()`` in both, and the port's gateway
serves JAX's ``ContinuousEngine.run`` greedy tokens."""
import asyncio
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.artifact import PrunedArtifact as JaxArtifact
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.batching import ContinuousEngine as JaxContinuousEngine
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.gateway import plan_placement as jax_plan_placement
from repro.serve.scheduler import Request as JaxRequest
from tests.conftest import small_config

from repro_torch.core.artifact import PrunedArtifact
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict, config_to_dict
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.gateway import (Gateway, GenerateRequest,
                                       ProtocolError, parse_request,
                                       plan_placement)
from repro_torch.serve.gateway import protocol as P
from repro_torch.serve.gateway.placement import kv_bytes_per_token
from repro_torch.serve.scheduler import Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")


@pytest.fixture(scope="module")
def served():
    cfg = config_from_dict(jax_config_to_dict(small_config()))
    return T.init_model(torch.Generator().manual_seed(0), cfg), cfg


def _serve_cfg(**kw):
    kw.setdefault("max_slots", 2)
    kw.setdefault("max_seq", 32)
    return ServeConfig(compute_dtype=torch.float32,
                       cache_dtype=torch.float32, **kw)


# -------------------------------------------------------------- protocol

def test_parse_request_happy_path():
    greq = parse_request({"tokens": [1, 2, 3], "max_new_tokens": 4,
                          "temperature": 0.5, "seed": 7, "priority": 2,
                          "prefix_id": "sys", "deadline_ms": 100,
                          "eos_id": 0, "stream": False}, vocab=256)
    assert greq.tokens == (1, 2, 3) and not greq.stream
    req = P.to_engine_request(greq, uid=9, vocab=256)
    assert isinstance(req, Request)
    assert (req.uid, req.priority, req.deadline_ms) == (9, 2, 100)


def test_parse_request_prompt_encodes_bytes():
    greq = parse_request({"prompt": "hi"}, vocab=256)
    req = P.to_engine_request(greq, uid=0, vocab=256)
    assert req.prompt == [ord("h"), ord("i")]


@pytest.mark.parametrize("body", [
    [],                                          # not an object
    {},                                          # neither prompt nor tokens
    {"prompt": "x", "tokens": [1]},              # both
    {"tokens": []},                              # empty
    {"tokens": [1, "a"]},                        # non-int
    {"tokens": [999999]},                        # out of vocab
    {"tokens": [1], "max_new_tokens": 0},
    {"tokens": [1], "deadline_ms": -5},
    {"tokens": [1], "seed": "x"},
    {"tokens": [1], "bogus": 1},                 # unknown field
])
def test_parse_request_rejects(body):
    with pytest.raises(ProtocolError):
        parse_request(body, vocab=256)


def test_request_fields_match_dataclass():
    from repro.serve.gateway import protocol as jax_P
    assert set(P.REQUEST_FIELDS) == {
        f.name for f in dataclasses.fields(GenerateRequest)}
    assert P.REQUEST_FIELDS == jax_P.REQUEST_FIELDS


# ------------------------------------------------------- token identity

async def _post(port: int, body: dict) -> bytes:
    r, w = await asyncio.open_connection("127.0.0.1", port)
    payload = json.dumps(body).encode()
    w.write(b"POST /generate HTTP/1.1\r\nHost: t\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload)
    await w.drain()
    data = await r.read()
    w.close()
    return data


def _events(data: bytes) -> list:
    return [json.loads(line) for line in
            data.partition(b"\r\n\r\n")[2].splitlines() if line.strip()]


def _gateway_tokens(engine, wire_reqs, temperature=0.0, seed=0) -> list:
    """Serve ``wire_reqs`` through a real HTTP gateway over ``engine``;
    returns ``(uid, tokens)`` in the order of ``wire_reqs``, each stream
    checked against its done event."""
    async def go():
        gw = await Gateway(engine, temperature=temperature,
                           seed=seed).start()
        results = await asyncio.gather(*[_post(gw.port, b)
                                         for b in wire_reqs])
        await gw.close()
        return results

    streamed = []
    for data in asyncio.run(go()):
        events = _events(data)
        done = [e for e in events if e["event"] == "done"]
        assert done, f"no terminal event in {events}"
        toks = [e["token"] for e in events if e["event"] == "token"]
        assert toks == done[0]["tokens"], "stream disagrees with done"
        streamed.append((done[0]["uid"], done[0]["tokens"]))
    return streamed


def _roundtrip(params, cfg, serve, wire_reqs, engine_reqs,
               temperature=0.0, seed=0):
    """The gateway's tokens for ``wire_reqs`` and the direct engine's for
    ``engine_reqs``, on identically configured engines."""
    fin, _ = ContinuousEngine(params, cfg, serve).run(
        engine_reqs, temperature=temperature, seed=seed)
    direct = {f.request.uid: f.tokens for f in fin}
    streamed = dict(_gateway_tokens(ContinuousEngine(params, cfg, serve),
                                    wire_reqs, temperature, seed))
    return direct, streamed


def test_gateway_token_identity_contiguous_sampled(served):
    params, cfg = served
    prompts = [[1, 2, 3, 4], [9, 8, 7], [5, 5, 5, 5, 5]]
    wire = [{"tokens": p, "max_new_tokens": 6, "temperature": 0.8,
             "seed": 40 + i} for i, p in enumerate(prompts)]
    engine = [Request(uid=i, prompt=p, max_new_tokens=6, temperature=0.8,
                      seed=40 + i) for i, p in enumerate(prompts)]
    direct, streamed = _roundtrip(params, cfg, _serve_cfg(), wire, engine)
    assert streamed == direct


def test_gateway_token_identity_paged_shared_prefix(served):
    params, cfg = served
    serve = _serve_cfg(max_seq=64, block_size=8, prefill_chunk=8)
    prefix = list(range(1, 17))
    tails = [[20 + i] for i in range(3)]
    wire = [{"tokens": prefix + t, "max_new_tokens": 5,
             "prefix_id": "sys"} for t in tails]
    engine = [Request(uid=i, prompt=prefix + t, max_new_tokens=5,
                      prefix_id="sys") for i, t in enumerate(tails)]
    direct, streamed = _roundtrip(params, cfg, serve, wire, engine)
    assert streamed == direct


# --------------------------------------------------------- http surface

async def _raw(port: int, request: bytes) -> bytes:
    r, w = await asyncio.open_connection("127.0.0.1", port)
    w.write(request)
    await w.drain()
    data = await r.read()
    w.close()
    return data


def _post_bytes(body: dict) -> bytes:
    payload = json.dumps(body).encode()
    return (b"POST /generate HTTP/1.1\r\n"
            b"Content-Length: %d\r\n\r\n" % len(payload) + payload)


def test_gateway_http_endpoints_and_rejects(served):
    params, cfg = served

    async def go():
        eng = ContinuousEngine(params, cfg, _serve_cfg(scheduler="slo"))
        gw = await Gateway(eng).start()

        health = await _raw(gw.port, b"GET /healthz HTTP/1.1\r\n\r\n")
        assert health.startswith(b"HTTP/1.1 200")
        assert json.loads(health.partition(b"\r\n\r\n")[2]) == {
            "status": "ok"}

        missing = await _raw(gw.port, b"GET /nope HTTP/1.1\r\n\r\n")
        assert missing.startswith(b"HTTP/1.1 404")

        resp = await _raw(gw.port, _post_bytes({"tokens": []}))
        assert resp.startswith(b"HTTP/1.1 400")
        assert json.loads(resp.partition(b"\r\n\r\n")[2])["event"] == \
            "error"

        # non-streaming: single JSON terminal event
        resp = await _raw(gw.port, _post_bytes(
            {"tokens": [1, 2], "max_new_tokens": 3, "stream": False}))
        done = json.loads(resp.partition(b"\r\n\r\n")[2])
        assert done["event"] == "done" and len(done["tokens"]) == 3
        assert set(done["metrics"]) == {"queue_ms", "prefill_ms",
                                        "decode_ms", "total_ms"}

        # oversize prompt -> structured rejected event on the wire
        resp = await _raw(gw.port, _post_bytes(
            {"tokens": [1] * 40, "max_new_tokens": 2, "stream": False}))
        rej = json.loads(resp.partition(b"\r\n\r\n")[2])
        assert rej == {"event": "rejected", "uid": rej["uid"],
                       "reason": "prompt_too_long"}

        metrics = await _raw(gw.port, b"GET /metrics HTTP/1.1\r\n\r\n")
        m = json.loads(metrics.partition(b"\r\n\r\n")[2])
        assert m["metrics"]["counters"]["requests.finished"] == 1.0
        assert m["metrics"]["counters"][
            "requests.rejected.prompt_too_long"] == 1.0
        assert "request.total_ms" in m["metrics"]["series"]
        assert m["stats"]["reject_reasons"] == {"prompt_too_long": 1}

        return await gw.close()

    fin, stats = asyncio.run(go())
    assert len(fin) == 1 and stats.rejected == 1
    assert stats.reject_reasons == {"prompt_too_long": 1}


# ----------------------------------------------------- crash propagation

def _crash_after(eng, n_bursts: int, exc: Exception):
    """Make the engine's decode burst raise on its ``n_bursts``-th call,
    as a device failure mid-serving would."""
    calls = {"n": 0}
    orig = eng._decode_burst

    def dying(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= n_bursts:
            raise exc
        return orig(*a, **kw)

    eng._decode_burst = dying


def test_gateway_engine_crash_streams_error_and_degrades(served):
    """Engine thread death mid-stream surfaces as a terminal wire
    ``error`` event carrying the request's uid (not a hang), flips
    /healthz to 503, refuses new submissions with 503, and re-raises
    from ``close()``."""
    params, cfg = served
    eng = ContinuousEngine(params, cfg, _serve_cfg())
    _crash_after(eng, 2, RuntimeError("injected device failure"))

    async def go():
        gw = await Gateway(eng).start()
        # long request: the first burst streams tokens, the second dies
        body = {"tokens": [1, 2, 3], "max_new_tokens": 30}
        events = _events(await _raw(gw.port, _post_bytes(body)))
        assert events, "stream hung instead of erroring"
        assert [e["event"] for e in events[:-1]].count("token") == \
            len(events) - 1
        assert len(events) > 1, "no tokens streamed before the crash"
        last = events[-1]
        assert last["event"] == "error" and last["uid"] == events[0]["uid"]
        assert "injected device failure" in last["error"]

        health = await _raw(gw.port, b"GET /healthz HTTP/1.1\r\n\r\n")
        assert health.startswith(b"HTTP/1.1 503")
        resp = await _raw(gw.port, _post_bytes(body))
        assert resp.startswith(b"HTTP/1.1 503")
        assert json.loads(resp.partition(b"\r\n\r\n")[2])["event"] == \
            "error"

        with pytest.raises(RuntimeError, match="injected device failure"):
            await gw.close()

    asyncio.run(go())


def test_gateway_engine_crash_buffered_returns_503(served):
    """On the buffered (``stream: false``) path an engine-death ``error``
    comes back as 503, not as a completion."""
    params, cfg = served
    eng = ContinuousEngine(params, cfg, _serve_cfg())
    _crash_after(eng, 1, RuntimeError("injected device failure"))

    async def go():
        gw = await Gateway(eng).start()
        data = await _raw(gw.port, _post_bytes(
            {"tokens": [4, 5, 6], "max_new_tokens": 8, "stream": False}))
        assert data.startswith(b"HTTP/1.1 503")
        ev = json.loads(data.partition(b"\r\n\r\n")[2])
        assert ev["event"] == "error" and "injected" in ev["error"]
        assert ev["uid"] == 0
        with pytest.raises(RuntimeError, match="injected device failure"):
            await gw.close()

    asyncio.run(go())


# ------------------------------------------------------------ placement

def _write_report(tmp_path, cfg):
    (tmp_path / "report.json").write_text(json.dumps(
        {"bytes_after": 1 << 20, "params_before": 1000,
         "params_after": 600}))
    (tmp_path / "config.json").write_text(json.dumps(config_to_dict(cfg)))


def test_plan_placement_from_report(tmp_path, served):
    _, cfg = served
    _write_report(tmp_path, cfg)
    # cfg: 2 periods x 1 attention layer, n_kv=2, head_dim=16, f32
    place = plan_placement(tmp_path, 8 << 20, max_seq=64, block_size=8,
                           cache_dtype=torch.float32, headroom=0.0)
    assert place.kv_token_bytes == 2 * 2 * 2 * 16 * 4
    assert kv_bytes_per_token(cfg) == 2 * 2 * 2 * 16 * 2     # bf16
    assert place.weights_bytes == 1 << 20
    assert place.density == pytest.approx(0.6)
    budget_tokens = ((8 << 20) - (1 << 20)) // place.kv_token_bytes
    # the arena allocates n_blocks + 1 (scratch) blocks, so one block of
    # the budget goes to scratch and the usable capacity excludes it
    expected_blocks = budget_tokens // 8 - 1
    assert place.serve.n_blocks == expected_blocks
    assert place.kv_tokens == expected_blocks * 8
    arena_bytes = (expected_blocks + 1) * 8 * place.kv_token_bytes
    assert place.weights_bytes + arena_bytes <= 8 << 20
    assert place.serve.paged and place.serve.max_seq == 64
    assert place.serve.max_slots <= expected_blocks // (64 // 8)

    contig = plan_placement(tmp_path, 8 << 20, max_seq=64,
                            cache_dtype=torch.float32, max_slots=4)
    assert contig.serve.max_slots == 4 and contig.serve.block_size is None

    with pytest.raises(ValueError):        # weights alone bust the budget
        plan_placement(tmp_path, 1 << 20, max_seq=64)


def test_plan_placement_rejects_bad_block_size(tmp_path, served):
    """A block_size above max_seq, or one that does not divide it, fails
    with a clear ValueError up front."""
    _, cfg = served
    _write_report(tmp_path, cfg)
    with pytest.raises(ValueError, match="block_size"):
        plan_placement(tmp_path, 8 << 20, max_seq=64, block_size=128,
                       cache_dtype=torch.float32)
    with pytest.raises(ValueError, match="block_size"):
        plan_placement(tmp_path, 8 << 20, max_seq=64, block_size=24,
                       cache_dtype=torch.float32)


def test_plan_placement_exact_budget_counts_scratch_block(tmp_path, served):
    """A budget with room for the weights plus exactly max_seq tokens of
    KV is refused on the paged path: the arena's scratch block would
    oversubscribe it; one more block of budget plans one slot."""
    _, cfg = served
    _write_report(tmp_path, cfg)
    per_tok = 2 * 2 * 2 * 16 * 4
    exact = (1 << 20) + 64 * per_tok        # weights + one sequence
    with pytest.raises(ValueError, match="scratch"):
        plan_placement(tmp_path, exact, max_seq=64, block_size=8,
                       cache_dtype=torch.float32, headroom=0.0)
    place = plan_placement(tmp_path, exact + 8 * per_tok, max_seq=64,
                           block_size=8, cache_dtype=torch.float32,
                           headroom=0.0)
    assert place.serve.max_slots == 1
    assert place.serve.n_blocks == 64 // 8
    arena_bytes = (place.serve.n_blocks + 1) * 8 * per_tok
    assert place.weights_bytes + arena_bytes <= exact + 8 * per_tok


# ------------------------------------------- across the two packages

@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """The golden-smoke bundle the JAX package saves from small_config."""
    jcfg = small_config()
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    jdir = str(tmp_path_factory.mktemp("gateway-bundle-jax"))
    JaxPipeline(JaxRecipe.load(RECIPE)).run(jparams, jcfg).save(jdir)
    return jdir


@pytest.mark.parametrize("block_size", [None, 16])
def test_plan_placement_equals_jax(jax_bundle, block_size):
    kw = dict(max_seq=64, block_size=block_size, headroom=0.05,
              max_slots=8, scheduler="priority")
    want = jax_plan_placement(jax_bundle, 4 << 20,
                              cache_dtype=jnp.float32, **kw)
    got = plan_placement(jax_bundle, 4 << 20, cache_dtype=torch.float32,
                         **kw)
    want, got = want.to_dict(), got.to_dict()
    want["serve"].pop("cache_dtype", None)
    assert got == want
    assert got["serve"]["max_slots"] >= 1


def test_gateway_greedy_tokens_equal_jax_run(jax_bundle):
    """The port's gateway serving the JAX-written bundle through the
    block-sparse plans and the paged pool gives the greedy tokens of
    JAX's ``ContinuousEngine.run`` on the same bundle."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 256, int(n)).tolist()
               for n in rng.integers(5, 30, 5)]
    jart = JaxArtifact.load(jax_bundle)
    jserve = JaxServeConfig(max_slots=3, max_seq=64, block_size=16,
                            prefill_chunk=16, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
    jfin, _ = JaxContinuousEngine.from_artifact(jart, jserve).run(
        [JaxRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    want = [list(f.tokens) for f in sorted(jfin,
                                           key=lambda f: f.request.uid)]
    art = PrunedArtifact.load(jax_bundle, torch.device("cpu"))
    assert art.packed
    serve = _serve_cfg(max_slots=3, max_seq=64, block_size=16,
                       prefill_chunk=16, paged_kernel=True)
    got = _gateway_tokens(ContinuousEngine.from_artifact(art, serve),
                          [{"tokens": p, "max_new_tokens": 6}
                           for p in prompts])
    assert [toks for _, toks in got] == want


def test_launcher_gateway_answers_and_stops(jax_bundle):
    """``launch/serve.py --gateway`` on the CPU over a bundle, its pools
    sized by ``--memory-budget``: it prints its ephemeral port, answers
    ``POST /generate`` and ``GET /healthz``, and stops on an interrupt
    with the engine's totals."""
    import signal
    import subprocess
    import sys
    import threading
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--artifact", jax_bundle, "--sparse", "--engine", "continuous",
         "--block-size", "16", "--gateway", "--port", "0",
         "--memory-budget", str(64 << 20), "--device", "cpu"],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    watchdog = threading.Timer(120, proc.kill)    # a hung start fails
    watchdog.start()
    try:
        lines = []
        for line in proc.stdout:
            lines.append(line)
            if "gateway listening on" in line:
                break
        assert any(ln.startswith("placement:") for ln in lines), lines
        port = int(lines[-1].split("127.0.0.1:")[1].split()[0])
        events = _events(asyncio.run(_post(port, {"tokens": [1, 2, 3],
                                                  "max_new_tokens": 4})))
        assert [e["event"] for e in events] == ["token"] * 4 + ["done"]
        health = asyncio.run(_raw(port, b"GET /healthz HTTP/1.1\r\n\r\n"))
        assert health.startswith(b"HTTP/1.1 200")
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=60)
        assert "gateway stopped: 4 tokens, 0 rejected" in out
    finally:
        watchdog.cancel()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
