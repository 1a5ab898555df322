"""The port's ContinuousEngine against the JAX package's.

The same requests go through both engines on the same params (JAX
``init_model``, through numpy), at f32: greedy tokens must be identical
for the contiguous pool, the paged pool on the gather path and on the
paged-attention op (its plain version on the CPU), with chunked prefill,
prefix sharing, a golden-smoke-pruned model served through its block
plans, and a prompt longer than ``DENSE_ATTN_MAX`` that prefills through
the long-attention branch. Inside the port, paged equals contiguous, the
copy-on-write reserve and admission backpressure behave as in the JAX
package, and the seeded sampler is batch-independent under mixed
temperatures.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.batching import ContinuousEngine as JaxContinuousEngine
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.sparse import plans_to_host as jax_plans_to_host
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy
from repro_torch.kernels import counters
from repro_torch.models.specs import config_from_dict
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import gumbel_noise, request_key
from repro_torch.serve.paging import BlockAllocator
from repro_torch.serve.scheduler import Request
from repro_torch.serve.sparse import plans_from_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")
CPU = torch.device("cpu")
BASE = dict(max_slots=3, max_seq=32, prefill_multiple=4)


@pytest.fixture(scope="module")
def models():
    """{"dense": (jax params, jax cfg, port params, port cfg, None, None),
    "sparse": the same for the golden-smoke-pruned model, with its JAX
    plans and the port's copy of them}."""
    jcfg = small_config()
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    out = {}
    art = JaxPipeline(JaxRecipe.load(RECIPE)).run(jparams, jcfg)
    for name, (jp, jc, jpacked) in {
            "dense": (jparams, jcfg, None),
            "sparse": (art.params, art.cfg, art.packed)}.items():
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                   CPU)
        packed = (plans_from_host(*jax_plans_to_host(jpacked), device=CPU)
                  if jpacked else None)
        out[name] = (jp, jc, params,
                     config_from_dict(jax_config_to_dict(jc)), jpacked,
                     packed)
    return out


def _mixed(R, vocab=256, n_new=8, prefix=None):
    rng = np.random.default_rng(0)
    if prefix is not None:
        return [R(uid=i, prompt=prefix + [50 + i], max_new_tokens=6,
                  prefix_id="sys") for i in range(5)]
    return [R(uid=i, prompt=rng.integers(1, vocab, (n,)).tolist(),
              max_new_tokens=n_new)
            for i, n in enumerate([5, 11, 3, 17, 9, 2])]


def _tokens(finished):
    return [f.tokens for f in sorted(finished, key=lambda f: f.request.uid)]


def _serve(jax_side: bool, **kw):
    if jax_side:
        return JaxServeConfig(compute_dtype=jnp.float32,
                              cache_dtype=jnp.float32, **kw)
    return ServeConfig(compute_dtype=torch.float32,
                       cache_dtype=torch.float32, **kw)


PREFIX = np.random.default_rng(1).integers(1, 256, (19,)).tolist()
VARIANTS = {
    "contiguous": ("dense", {}, None),
    "paged": ("dense", {"block_size": 8}, None),
    "paged-chunked-odd-arena": ("dense", {"block_size": 4, "n_blocks": 30,
                                          "prefill_chunk": 8}, None),
    "paged-kernel-chunked": ("dense", {"block_size": 8, "prefill_chunk": 8,
                                       "paged_kernel": True}, None),
    "prefix-gather": ("dense", {"block_size": 8, "prefill_chunk": 8},
                      PREFIX),
    "prefix-kernel": ("dense", {"block_size": 8, "prefill_chunk": 8,
                                "paged_kernel": True}, PREFIX),
    "sparse-contiguous": ("sparse", {}, None),
    "sparse-prefix-kernel": ("sparse", {"block_size": 8, "prefill_chunk": 8,
                                        "paged_kernel": True}, PREFIX),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_continuous_engine_tokens_equal_jax(models, variant):
    model, extra, prefix = VARIANTS[variant]
    jp, jc, params, cfg, jpacked, packed = models[model]
    jeng = JaxContinuousEngine(jp, jc, _serve(True, **BASE, **extra),
                               packed=jpacked)
    want, jstats = jeng.run(_mixed(JaxRequest, prefix=prefix))
    eng = ContinuousEngine(params, cfg, _serve(False, **BASE, **extra),
                           packed=packed)
    counters.reset()
    got, stats = eng.run(_mixed(Request, prefix=prefix))
    assert counters.snapshot() == {}, "CPU runs launch no kernel"
    assert _tokens(got) == _tokens(want)
    for field in ("ticks", "generated_tokens", "prefills", "rejected",
                  "prefill_chunks", "peak_concurrency",
                  "prompt_blocks_shared", "prefix_hit_rate"):
        assert getattr(stats, field) == getattr(jstats, field), field
    if prefix is not None:
        assert stats.prompt_blocks_shared >= 4
    if "block_size" in extra:
        alloc = eng.last_allocator
        assert alloc.n_free == alloc.n_blocks, "every block came back"


def test_long_prompt_prefill_tokens_equal_jax(models):
    """A 3072-token prompt (> DENSE_ATTN_MAX, a multiple of 1024) on the
    contiguous pool prefills through the long-attention branch."""
    jp, jc, params, cfg, _, _ = models["dense"]
    rng = np.random.default_rng(9)
    prompts = [rng.integers(1, 256, (n,)).tolist() for n in (3072, 7, 40)]
    serve = dict(max_slots=2, max_seq=3088, prefill_multiple=16)
    want, _ = JaxContinuousEngine(jp, jc, _serve(True, **serve)).run(
        [JaxRequest(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    got, stats = ContinuousEngine(params, cfg, _serve(False, **serve)).run(
        [Request(uid=i, prompt=p, max_new_tokens=6)
         for i, p in enumerate(prompts)])
    assert _tokens(got) == _tokens(want) and stats.rejected == 0


def test_paged_matches_contiguous_in_port(models):
    _, _, params, cfg, _, packed = models["sparse"]
    ref, _ = ContinuousEngine(params, cfg, _serve(False, **BASE),
                              packed=packed).run(_mixed(Request))
    for extra in ({"block_size": 8}, {"block_size": 8, "prefill_chunk": 8},
                  {"block_size": 4, "n_blocks": 30, "paged_kernel": True}):
        got, stats = ContinuousEngine(
            params, cfg, _serve(False, **BASE, **extra),
            packed=packed).run(_mixed(Request))
        assert _tokens(got) == _tokens(ref), extra
        assert stats.rejected == 0


def test_cow_reserve_and_backpressure(models, monkeypatch):
    """Forced copy-on-write consumes the admission-time reserve at zero
    free blocks; tokens survive it. Admission holds requests when the
    arena is full and rejects one that can never fit."""
    _, _, params, cfg, _, _ = models["dense"]
    calls, cow = [], []
    orig = BlockAllocator.ensure_writable

    def spy(self, table, j, pool, reserve=None):
        calls.append((self.n_free, reserve))
        if reserve is not None and int(table[j]) != reserve:
            b = int(table[j])
            self.retain([b])            # a stale reader forces the copy
            pool = orig(self, table, j, pool, reserve=reserve)
            self.release([b])
            assert int(table[j]) == reserve
            cow.append(b)
            return pool
        return orig(self, table, j, pool, reserve=reserve)

    prefix = np.random.default_rng(4).integers(1, 256, (17,)).tolist()
    reqs = lambda: [Request(uid=i, prompt=prefix + [60 + i],  # noqa: E731
                            max_new_tokens=6, prefix_id="sys")
                    for i in range(4)]
    serve = _serve(False, **{**BASE, "max_slots": 2}, block_size=8,
                   prefill_chunk=8, n_blocks=6)
    monkeypatch.setattr(BlockAllocator, "ensure_writable", spy)
    fin, stats = ContinuousEngine(params, cfg, serve).run(reqs())
    assert len(fin) == 4 and stats.rejected == 0 and cow
    assert any(free == 0 and r is not None for free, r in calls)
    monkeypatch.setattr(BlockAllocator, "ensure_writable", orig)
    ref, _ = ContinuousEngine(params, cfg, serve).run(reqs())
    assert _tokens(fin) == _tokens(ref)

    tight = _serve(False, **{**BASE, "max_seq": 16}, block_size=4,
                   n_blocks=8)
    fin, stats = ContinuousEngine(params, cfg, tight).run(
        [Request(uid=i, prompt=[7] * 6, max_new_tokens=10)
         for i in range(5)])
    assert len(fin) == 5 and stats.peak_concurrency == 2
    tiny = _serve(False, **{**BASE, "max_seq": 16}, block_size=4,
                  n_blocks=2)
    fin, stats = ContinuousEngine(params, cfg, tiny).run(
        [Request(uid=0, prompt=[7] * 6, max_new_tokens=10),
         Request(uid=1, prompt=[7] * 2, max_new_tokens=2)])
    assert stats.reject_reasons == {"insufficient_blocks": 1}
    assert [f.request.uid for f in fin] == [1]


def test_seeded_sampler_is_batch_independent_with_mixed_temperatures(models):
    _, _, params, cfg, _, _ = models["dense"]
    probe = lambda uid: Request(uid=uid, prompt=[9, 8, 7],  # noqa: E731
                                max_new_tokens=6, temperature=0.9, seed=123)
    noise = [Request(uid=i, prompt=[i + 1] * 5, max_new_tokens=6,
                     temperature=t, seed=i)
             for i, t in ((1, 0.5), (2, 0.0), (3, 1.3))]
    eng = ContinuousEngine(params, cfg, _serve(False, **BASE))
    alone, _ = eng.run([probe(0)])
    crowded, _ = eng.run([probe(0)] + noise)
    assert alone[0].tokens == _tokens(crowded)[0]
    paged = ContinuousEngine(params, cfg, _serve(False, **BASE, block_size=8,
                                                 paged_kernel=True))
    crowded_paged, _ = paged.run(noise[::-1] + [probe(0)])
    assert alone[0].tokens == _tokens(crowded_paged)[0]
    # the greedy request decoded greedily inside the mixed batch
    greedy, _ = eng.run([Request(uid=2, prompt=noise[1].prompt,
                                 max_new_tokens=6)])
    assert _tokens(crowded)[2] == greedy[0].tokens
    # a sampled stream differs from greedy and from another seed's
    other, _ = eng.run([Request(uid=0, prompt=[9, 8, 7], max_new_tokens=6,
                                temperature=0.9, seed=124)])
    assert other[0].tokens != alone[0].tokens


def test_sampler_stream_is_keyed_and_gumbel_distributed():
    keys = torch.tensor([request_key(5, 0, 0), request_key(5, 7, 3),
                         request_key(None, 7, 3)], dtype=torch.int64)
    assert int(keys[0]) == int(keys[1]), "a seed wins over uid and run"
    assert int(keys[2]) != int(keys[0])
    assert request_key(None, 7, 3) != request_key(None, 8, 3)
    g = gumbel_noise(keys, torch.tensor([0, 0, 0]), 20000)
    assert torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    assert torch.isfinite(g).all()
    g1 = gumbel_noise(keys[:1], torch.tensor([1]), 20000)
    assert not torch.equal(g1[0], g[0]), "each token count has its noise"
    # Gumbel(0, 1): mean = Euler's gamma, variance = pi^2 / 6
    assert abs(float(g.mean()) - 0.5772) < 0.03
    assert abs(float(g.var()) - np.pi ** 2 / 6) < 0.08
