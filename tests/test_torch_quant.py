"""The int8 kept-tile path of the port against the JAX package, at f32 on
the CPU (the port of ``tests/test_quant_kernels.py``).

Inputs come from numpy seeds and go to both packages. ``quantize_tiles``
must give JAX's ``q`` and scales bit for bit (the scale exponent is
JAX's numpy expression on the host), including a tile whose
``amax / 127`` lies one ulp above a power of two; the plan storage
(``plan_slots``, ``gather_kept_tiles``, packed tiles, scales and slots)
and the fake-quant weights are equal to JAX's. The plain versions of
kernels 5, 8 and 9 agree with the Pallas kernels in interpret mode and
with JAX's references, and are bitwise equal to the port's plain kernels
1, 6 and 7 over the dequantised weights. On JAX's small dense + MoE
config pruned with ``quant="int8"`` the pack report, bundles (either
way) and the engines' greedy tokens match JAX's.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import quant as jax_quant
from repro.core.artifact import PrunedArtifact as JaxArtifact
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.recipe import CalibrationSpec as JaxCalibration
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.kernels.block_sparse import ops as jax_bs_ops
from repro.kernels.block_sparse import ref as jax_bs_ref
from repro.kernels.grouped_block_sparse import ops as jax_gbs_ops
from repro.kernels.grouped_block_sparse import ref as jax_gbs_ref
from repro.models import transformer as jax_T
from repro.models.specs import AttentionSpec as JaxAttention
from repro.models.specs import LayerSpec as JaxLayer
from repro.models.specs import MLPSpec as JaxMLP
from repro.models.specs import ModelConfig as JaxModelConfig
from repro.models.specs import MoESpec as JaxMoE
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve import sparse as jax_sparse
from repro.serve.batching import ContinuousEngine as JaxContinuousEngine
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.core import quant
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.kernels import counters
from repro_torch.kernels.block_sparse import ops as bs_ops
from repro_torch.kernels.block_sparse import ref as bs_ref
from repro_torch.kernels.grouped_block_sparse import ops as gbs_ops
from repro_torch.kernels.grouped_block_sparse import ref as gbs_ref
from repro_torch.models.specs import config_from_dict
from repro_torch.serve import sparse
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine, make_sparse_mlp_apply
from repro_torch.serve.scheduler import Request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
BLOCK = 16
# kernels: the port's plain versions against the Pallas kernels and JAX's
# references, f32 on the CPU (sum order only)
KERNEL_TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _block_structured(rng, K, N, keep=0.4):
    """A (K, N) f32 weight with whole 16x16 tiles kept, an empty first
    column and a full second one."""
    w = rng.standard_normal((K, N)).astype(np.float32)
    bm = rng.random((K // BLOCK, N // BLOCK)) < keep
    bm[:, 0] = False
    bm[:, 1] = True
    return w * np.repeat(np.repeat(bm, BLOCK, 0), BLOCK, 1)


def _jax_plan(w):
    bm = jax_bs_ops.block_mask_from_weight_mask(w != 0, BLOCK, BLOCK)
    return jax_bs_ops.plan_blocks(bm)


# --------------------------------------------------- per-tile quantisation

def _near_pow2_tiles():
    """Tiles whose amax / 127 lies one f32 ulp above 2^k for k in
    -20 .. 20 (found by stepping amax up from 127 * 2^k), beside the
    exact power and one ulp below."""
    out = []
    for k in range(-20, 21, 5):
        target = np.float32(2.0 ** k)
        amax = np.float32(127) * target
        while np.float32(amax) / np.float32(127) <= target:
            amax = np.nextafter(amax, np.float32(np.inf))
        assert np.float32(amax) / np.float32(127) == np.nextafter(
            target, np.float32(np.inf))
        for a in (amax, np.float32(127) * target,
                  np.nextafter(np.float32(127) * target, np.float32(0))):
            t = np.zeros((BLOCK, BLOCK), np.float32)
            t[3, 5] = -a
            t[0, 0] = a / 3
            out.append(t)
    return np.stack(out)


def test_quantize_tiles_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    mags = 2.0 ** rng.integers(-20, 21, 40)
    tiles = (rng.standard_normal((40, BLOCK, BLOCK)) * mags[:, None, None]
             ).astype(np.float32)
    tiles[0] = 0.0                                   # all-zero tile
    tiles = np.concatenate([tiles, _near_pow2_tiles()])
    q, scales = quant.quantize_tiles(_t(tiles))
    jq, jscales = jax_quant.quantize_tiles(tiles)
    assert q.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(scales.numpy().view(np.uint32),
                                  jscales.view(np.uint32))
    assert scales[0] == 1.0 and not q[0].any()
    np.testing.assert_array_equal(
        quant.dequantize_tiles(q, scales).numpy(),
        jax_quant.dequantize_tiles(jq, jscales))


def test_quantize_tiles_bf16_roundtrip_exact():
    rng = np.random.default_rng(1)
    q, scales = quant.quantize_tiles(_t(rng.standard_normal(
        (4, BLOCK, BLOCK)).astype(np.float32)))
    fq = quant.dequantize_tiles(q, scales)
    assert torch.equal(fq.bfloat16().float(), fq)


def test_quantize_array_and_model_match_jax():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((40, 3, 5)).astype(np.float32)
    w[0, 0, 0] = 1e4
    q, scale, shape, pad = quant.quantize_array(_t(w), bits=8, group=16)
    jq, jscale, jshape, jpad = jax_quant.quantize_array(jnp.asarray(w),
                                                        bits=8, group=16)
    assert (tuple(shape), pad) == (tuple(jshape), jpad)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(scale.numpy(), np.asarray(jscale),
                               rtol=1e-6)
    np.testing.assert_allclose(
        quant.dequantize_array(q, scale, shape, pad).numpy(),
        np.asarray(jax_quant.dequantize_array(jq, jscale, jshape, jpad)),
        rtol=1e-6, atol=1e-6)
    jcfg, cfg = _cfgs()
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    qp, stats = quant.quantize_model(params, cfg, bits=8, group=16)
    jqp, jstats = jax_quant.quantize_model(jparams, jcfg, bits=8, group=16)
    assert stats == pytest.approx(jstats, rel=1e-12)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(qp)),
                    jax.tree_util.tree_leaves(jqp)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- plan storage

def test_plan_slots_and_gather_match_jax():
    rng = np.random.default_rng(3)
    w = _block_structured(rng, 64, 96)
    jcounts, jindices = _jax_plan(w)
    counts, indices = bs_ops.plan_blocks(
        bs_ops.block_mask_from_weight_mask(_t(w) != 0, BLOCK, BLOCK))
    slots, total = bs_ops.plan_slots(counts, indices.shape[1])
    jslots, jtotal = jax_bs_ops.plan_slots(jcounts, jindices.shape[1])
    np.testing.assert_array_equal(slots, jslots)
    assert total == jtotal and slots.dtype == np.int32
    tiles = bs_ops.gather_kept_tiles(_t(w), _t(counts), _t(indices), BLOCK)
    np.testing.assert_array_equal(tiles.numpy(), jax_bs_ops.gather_kept_tiles(
        w, jcounts, jindices, BLOCK, BLOCK))
    # a plan that keeps nothing stores one zero tile at row 0
    empty = np.zeros_like(w)
    c0, i0 = bs_ops.plan_blocks(np.zeros((4, 6), bool))
    s0, t0 = bs_ops.plan_slots(c0, i0.shape[1])
    assert t0 == 0 and not s0.any()
    g0 = bs_ops.gather_kept_tiles(_t(empty), _t(c0), _t(i0), BLOCK)
    assert g0.shape == (1, BLOCK, BLOCK) and not g0.any()


def _expert_weights(seed, E=4, K=64, N=48):
    """An expert stack with per-expert densities, expert 2 empty."""
    rng = np.random.default_rng(seed)
    ws = np.stack([_block_structured(rng, K, N, keep=0.3 + 0.15 * e)
                   for e in range(E)])
    ws[2] = 0.0
    return ws


def test_packed_storage_matches_jax():
    rng = np.random.default_rng(4)
    w = _block_structured(rng, 64, 96)
    p = sparse.pack_projection(_t(w), BLOCK, quant="int8")
    jp = jax_sparse.pack_projection(w, BLOCK, quant="int8")
    for name in ("counts", "indices", "tiles", "scales", "slots"):
        np.testing.assert_array_equal(getattr(p, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    assert p.tiles.dtype == torch.int8 and p.quant == "int8"
    q, scales, slots = sparse._quantize_plan(_t(w), p.counts, p.indices,
                                             BLOCK)
    jq, jscales, jslots = jax_sparse._quantize_plan(w, jp.counts,
                                                    jp.indices, BLOCK)
    for a, b in ((q, jq), (scales, jscales), (slots, jslots)):
        np.testing.assert_array_equal(a.numpy(), b)
    ws = _expert_weights(5)
    pe = sparse.pack_expert_projection(_t(ws), BLOCK, ragged=True,
                                       quant="int8")
    jpe = jax_sparse.pack_expert_projection(ws, BLOCK, ragged=True,
                                            quant="int8")
    for name in ("counts", "indices", "tiles", "scales", "slots"):
        np.testing.assert_array_equal(getattr(pe, name).numpy(),
                                      np.asarray(getattr(jpe, name)), name)
    # the per-expert view carries the whole tile array, absolute slots
    v, jv = pe.expert(3), jpe.expert(3)
    assert v.tiles is pe.tiles
    np.testing.assert_array_equal(v.slots.numpy(), np.asarray(jv.slots))


def test_dequantized_weight_and_fake_quant_match_jax():
    rng = np.random.default_rng(6)
    w = _block_structured(rng, 64, 96)
    p = sparse.pack_projection(_t(w), BLOCK, quant="int8")
    jp = jax_sparse.pack_projection(w, BLOCK, quant="int8")
    np.testing.assert_array_equal(sparse.dequantized_weight(p, 64).numpy(),
                                  jax_sparse.dequantized_weight(jp, 64))
    ws = _expert_weights(7)
    pe = sparse.pack_expert_projection(_t(ws), BLOCK, quant="int8")
    jpe = jax_sparse.pack_expert_projection(ws, BLOCK, quant="int8")
    want = np.stack([jax_sparse.dequantized_weight(jpe.expert(e), 64)
                     for e in range(ws.shape[0])])
    np.testing.assert_array_equal(sparse.dequantized_weight(pe, 64).numpy(),
                                  want)
    with pytest.raises(ValueError, match="int8"):
        sparse.dequantized_weight(sparse.pack_projection(_t(w), BLOCK), 64)


# ------------------------------------------------- the kernels' plain versions

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_block_sparse_quant_plain_matches_kernel1_and_pallas(dtype):
    rng = np.random.default_rng(8)
    w = _block_structured(rng, 64, 96)
    p = sparse.pack_projection(_t(w), BLOCK, quant="int8")
    wfq = sparse.dequantized_weight(p, 64)
    x = _t(rng.standard_normal((32, 64)).astype(np.float32)).to(dtype)
    y = bs_ops.quant_blocksparse_matmul(x, p.tiles, p.counts, p.indices,
                                        p.slots, p.scales, BLOCK)
    y1 = bs_ops.blocksparse_matmul(x, wfq.to(dtype), p.counts, p.indices,
                                   BLOCK)
    assert y.dtype == dtype and torch.equal(y, y1)
    if dtype != torch.float32:
        return
    jp = jax_sparse.pack_projection(w, BLOCK, quant="int8")
    jy = jax_bs_ops.quant_blocksparse_matmul(
        jnp.asarray(x.numpy()), jp.tiles, jp.counts, jp.indices, jp.slots,
        jp.scales, block_m=BLOCK, block_k=BLOCK, block_n=BLOCK,
        interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    bm = jax_bs_ops.block_mask_from_weight_mask(w != 0, BLOCK, BLOCK)
    jref = jax_bs_ref.block_sparse_matmul_ref(
        jnp.asarray(x.numpy()), jnp.asarray(wfq.numpy()), bm, BLOCK, BLOCK)
    np.testing.assert_allclose(y.numpy(), np.asarray(jref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert not y[:, :BLOCK].any(), "the empty column is zeros"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_and_ragged_quant_plain_match_kernels_6_7_and_pallas(dtype):
    rng = np.random.default_rng(9)
    ws = _expert_weights(10)
    E, K, N = ws.shape
    pe = sparse.pack_expert_projection(_t(ws), BLOCK, ragged=True,
                                       quant="int8")
    wfq = sparse.dequantized_weight(pe, K)
    args = (pe.tiles, pe.counts, pe.indices, pe.slots, pe.scales)
    xs = _t(rng.standard_normal((E, 16, K)).astype(np.float32)).to(dtype)
    live = torch.ones((E, 16), dtype=torch.bool)
    live[1, 4:] = False
    live[3] = False
    yg = gbs_ops.quant_grouped_blocksparse_matmul(xs, *args, BLOCK,
                                                  row_live=live)
    yg6 = gbs_ops.grouped_blocksparse_matmul(xs, wfq.to(dtype), pe.counts,
                                             pe.indices, BLOCK,
                                             row_live=live)
    assert yg.dtype == dtype and torch.equal(yg, yg6)
    tile_expert = torch.tensor([0, 1, 1, 3, -1], dtype=torch.int32)
    xp = _t(rng.standard_normal((80, K)).astype(np.float32)).to(dtype)
    yr = gbs_ops.quant_ragged_blocksparse_matmul(xp, *args, tile_expert,
                                                 BLOCK)
    yr7 = gbs_ops.ragged_blocksparse_matmul(xp, wfq.to(dtype), pe.counts,
                                            pe.indices, tile_expert, BLOCK)
    assert torch.equal(yr, yr7) and not yr[64:].any()
    if dtype != torch.float32:
        return
    jpe = jax_sparse.pack_expert_projection(ws, BLOCK, ragged=True,
                                            quant="int8")
    jargs = (jpe.tiles, jpe.counts, jpe.indices, jpe.slots, jpe.scales)
    jyg = jax_gbs_ops.quant_grouped_blocksparse_matmul(
        jnp.asarray(xs.numpy()), *jargs, block_k=BLOCK, block_n=BLOCK,
        interpret=True, row_live=jnp.asarray(live.numpy()))
    np.testing.assert_allclose(yg.numpy(), np.asarray(jyg),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    jyr = jax_gbs_ops.quant_ragged_blocksparse_matmul(
        jnp.asarray(xp.numpy()), *jargs, jnp.asarray(tile_expert.numpy()),
        block_k=BLOCK, block_n=BLOCK, interpret=True)
    np.testing.assert_allclose(yr.numpy(), np.asarray(jyr), rtol=KERNEL_TOL,
                               atol=KERNEL_TOL)
    masks = np.stack([np.asarray(jax_bs_ops.block_mask_from_weight_mask(
        ws[e] != 0, BLOCK, BLOCK)) for e in range(E)])
    jref = jax_gbs_ref.grouped_block_sparse_matmul_ref(
        jnp.asarray(xs.numpy()), jnp.asarray(wfq.numpy()), masks, BLOCK,
        BLOCK)
    rows = live.numpy()
    np.testing.assert_allclose(yg.numpy()[rows], np.asarray(jref)[rows],
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    jrref = jax_gbs_ref.ragged_block_sparse_matmul_ref(
        jnp.asarray(xp.numpy()), jnp.asarray(wfq.numpy()),
        tile_expert.numpy(), 16, masks, BLOCK, BLOCK)
    np.testing.assert_allclose(yr.numpy(), np.asarray(jrref),
                               rtol=KERNEL_TOL, atol=KERNEL_TOL)
    assert counters.snapshot() == {}, "CPU runs launch no kernel"


# --------------------------------------- the pipeline, bundles and engines

def _cfgs():
    """JAX's ``_cfg()`` of ``tests/test_quant_kernels.py`` (one dense and
    one MoE layer) and the port's copy of it."""
    attn = JaxAttention(n_q=4, n_kv=2, head_dim=16)
    jcfg = JaxModelConfig(
        name="quant-kernels-test", d_model=64, vocab=256,
        vocab_pad_multiple=16,
        pattern=(JaxLayer(attn, JaxMLP(d_ff=128)),
                 JaxLayer(attn, JaxMoE(n_experts=4, top_k=2, d_ff=64))),
        n_periods=1, scan_layers=False, remat=False)
    return jcfg, config_from_dict(jax_config_to_dict(jcfg))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, cfg = _cfgs()
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    kw = dict(p=0.6, category="unstructured", selector="wanda_block",
              block=BLOCK, ragged_moe=True, quant="int8")
    jart = JaxPipeline(JaxRecipe(arch=jcfg.name, **kw,
                                 calibration=JaxCalibration(4, 2, 16))
                       ).run(jparams, jcfg)
    art = MosaicPipeline(PruneRecipe(arch=cfg.name, **kw,
                                     calibration=CalibrationSpec(4, 2, 16))
                         ).run(params, cfg)
    dirs = {"jax": str(tmp_path_factory.mktemp("quant-jax")),
            "port": str(tmp_path_factory.mktemp("quant-port"))}
    jart.save(dirs["jax"])
    art.save(dirs["port"])
    return dict(art=art, jart=jart, dirs=dirs)


def test_pipeline_quant_report_matches_jax(setup):
    art, jart = setup["art"], setup["jart"]
    rep, jrep = art.report, jart.report
    for key in ("quant", "params_before", "params_after", "bytes_before",
                "bytes_after"):
        assert rep[key] == jrep[key], key
    assert rep["bytes_after"] < rep["bytes_before"]
    assert rep["pack"]["quant"] == "int8"
    assert rep["pack"]["quant_bytes"] == jrep["pack"]["quant_bytes"]
    assert rep["pack"]["quant_bytes"]["ratio_vs_bf16"] < 0.5
    # the params are the fake-quant round trip of the plans, as in JAX
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(art.params)),
                    jax.tree_util.tree_leaves(jart.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    p = art.packed[(0, "up")]
    w = art.params["blocks"][0]["mlp"]["up"]
    assert torch.equal(w, sparse.dequantized_weight(p, w.shape[0]))


def _plans_equal(packed, jpacked):
    assert set(packed) == set(jpacked)
    for k, jp in jpacked.items():
        p = packed[k]
        assert type(p).__name__ == type(jp).__name__ and p.quant == "int8"
        for name in ("counts", "indices", "tiles", "scales", "slots"):
            np.testing.assert_array_equal(getattr(p, name).numpy(),
                                          np.asarray(getattr(jp, name)))
        assert p.tiles.dtype == torch.int8


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_quant_bundles_cross_load(setup, saved_by):
    d = setup["dirs"][saved_by]
    art = PrunedArtifact.load(d, device="cpu")
    jart = JaxArtifact.load(d)
    _plans_equal(art.packed, jart.packed)
    _plans_equal(art.packed, setup["jart"].packed)
    _plans_equal(sparse.plans_from_host(*sparse.plans_to_host(art.packed)),
                 jart.packed)
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(art.params)),
                    jax.tree_util.tree_leaves(jart.params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_static_engine_tokens_equal_jax_every_quant(setup):
    art = PrunedArtifact.load(setup["dirs"]["port"], device="cpu")
    jart = JaxArtifact.load(setup["dirs"]["port"])
    prompt = np.random.default_rng(1).integers(0, 256, (2, 12))
    want = None
    for q in (None, "int8", "none"):
        jeng = JaxEngine.from_artifact(jart, JaxServeConfig(
            max_seq=24, compute_dtype=jnp.float32, cache_dtype=jnp.float32,
            quant=q))
        want_q = np.asarray(jeng.generate(jnp.asarray(prompt), 8))
        want = want_q if want is None else want
        np.testing.assert_array_equal(want_q, want)
        for a in (art, setup["art"]):
            eng = Engine.from_artifact(a, ServeConfig(
                max_seq=24, compute_dtype=torch.float32,
                cache_dtype=torch.float32, quant=q))
            np.testing.assert_array_equal(eng.generate(prompt, 8).numpy(),
                                          want, err_msg=str(q))


def test_bf16_engine_streams_int8_tiles_bitwise_to_none(setup):
    """At a bf16 compute dtype the engine casts the params, never the
    plans: tiles stay int8 and scales f32, and the int8 path's logits
    equal the "none" path's over the cast fake-quant weights."""
    art = setup["art"]
    prompt = np.random.default_rng(3).integers(0, 256, (2, 12))
    out = {}
    for q in ("int8", "none"):
        eng = Engine.from_artifact(art, ServeConfig(
            max_seq=20, compute_dtype=torch.bfloat16,
            cache_dtype=torch.bfloat16, quant=q))
        out[q] = eng.generate(prompt, 6, return_logits=True)
    assert torch.equal(out["int8"][1], out["none"][1])
    assert torch.equal(out["int8"][0], out["none"][0])
    for p in art.packed.values():
        assert p.tiles.dtype == torch.int8 and p.scales.dtype == torch.float32


def test_continuous_engine_tokens_equal_jax_every_quant(setup):
    art = PrunedArtifact.load(setup["dirs"]["jax"], device="cpu")
    jart = JaxArtifact.load(setup["dirs"]["jax"])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, (n,)).tolist() for n in (5, 9, 7)]
    kw = dict(max_slots=2, max_seq=32)
    jeng = JaxContinuousEngine.from_artifact(jart, JaxServeConfig(
        compute_dtype=jnp.float32, cache_dtype=jnp.float32, quant="int8",
        **kw))
    want, _ = jeng.run([JaxRequest(uid=i, prompt=p, max_new_tokens=6)
                        for i, p in enumerate(prompts)])
    want = {f.request.uid: f.tokens for f in want}
    for q in (None, "int8", "none"):
        for pool in ({}, {"block_size": 8, "paged_kernel": True}):
            eng = ContinuousEngine.from_artifact(art, ServeConfig(
                compute_dtype=torch.float32, cache_dtype=torch.float32,
                quant=q, **kw, **pool))
            got, _ = eng.run([Request(uid=i, prompt=p, max_new_tokens=6)
                              for i, p in enumerate(prompts)])
            assert {f.request.uid: f.tokens for f in got} == want, (q, pool)


def test_serve_config_quant_validation_and_upfront_raise(setup):
    with pytest.raises(ValueError, match="quant"):
        ServeConfig(quant="fp8")
    assert ServeConfig().quant is None and ServeConfig(quant="int8").quant
    art = setup["art"]
    bare = {k: dataclasses.replace(p, quant="none", tiles=None, scales=None,
                                   slots=None)
            for k, p in art.packed.items()}
    with pytest.raises(ValueError, match="int8"):
        make_sparse_mlp_apply(bare, quant="int8")
    with pytest.raises(ValueError, match="int8"):
        Engine(art.params, art.cfg, ServeConfig(quant="int8"), packed=bare)
    make_sparse_mlp_apply(art.packed, quant="int8")
    make_sparse_mlp_apply(bare, quant="none")


def test_quant_cli_prunes_and_serves_on_cpu(tmp_path):
    """``recipes/quant-smoke.json`` through the port's launchers; the JAX
    launcher serves the port's bundle to the same sample tokens."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = str(tmp_path / "q")

    def run(*args, port=True):
        cmd = [sys.executable, "-m", *args] + (["--device", "cpu"]
                                                if port else [])
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    assert "saved PrunedArtifact" in run(
        "repro_torch.launch.prune", "--smoke", "--recipe",
        os.path.join(REPO, "recipes", "quant-smoke.json"), "--out", out)
    s = run("repro_torch.launch.serve", "--smoke", "--artifact", out,
            "--sparse", "--quant", "int8")
    assert "6 saved plans" in s and "generated (4, 64)" in s
    s_none = run("repro_torch.launch.serve", "--smoke", "--artifact", out,
                 "--sparse", "--quant", "none")
    s_jax = run("repro.launch.serve", "--smoke", "--artifact", out,
                "--sparse", "--quant", "int8", port=False)
    sample = [ln for ln in s.splitlines() if ln.startswith("sample:")]
    assert sample and sample[0] in s_none.splitlines() \
        and sample[0] in s_jax.splitlines()
    assert JaxArtifact.load(out).report["pack"]["quant"] == "int8"
