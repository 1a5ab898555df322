"""The MoE slice end to end against the JAX package, at f32 on the CPU:
``recipes/moe-smoke.json`` (composite, ``wanda_block``, block 16, grouped
expert plans, ragged decode) on qwen3-moe-30b-a3b at smoke size.

Both packages start from the same params (JAX ``init_model``, through
numpy) and the same calibration tokens. Per-expert activation norms, POD
ranks and targets agree within a tolerance; given JAX's targets, masks,
the pruned config and the expert plan stacks are equal. Bundles saved by
either package load in the other with their expert stacks and flags, and
the static and continuous engines give the JAX engines' greedy tokens on
the grouped, per-expert loop and ragged paths, in memory and loaded.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core import pod as jax_pod
from repro.core import unstructured as jax_U
from repro.core.artifact import PrunedArtifact as JaxArtifact
from repro.core.composite import prune_composite as jax_prune_composite
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.rank_controller import profile_model as jax_profile_model
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.batching import ContinuousEngine as JaxContinuousEngine
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.scheduler import Request as JaxRequest
from repro.serve.sparse import PackedExpertProjection as JaxExpertPlan

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.core import pod
from repro_torch.core import unstructured as U
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.composite import prune_composite
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import profile_model
from repro_torch.core.recipe import PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels import counters
from repro_torch.models.specs import config_from_dict, config_to_dict
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.sparse import (PackedExpertProjection, flop_savings,
                                      pack_model)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "moe-smoke.json")
ARCH = "qwen3-moe-30b-a3b"
CPU = torch.device("cpu")
S0, N_NEW = 10, 8
# path name -> ServeConfig MoE fields
PATHS = {"grouped": dict(group_experts=True, ragged_moe=False),
         "loop": dict(group_experts=False, ragged_moe=False),
         "ragged": dict(group_experts=True, ragged_moe=True)}


def _calibration(vocab, recipe):
    c = recipe.calibration
    return SyntheticCorpus(vocab, seed=c.seed).calibration_batches(
        c.n_samples, c.batch_size, c.seq_len)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jax_get_smoke_config(ARCH).replace(n_periods=2, scan_layers=False)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    jrecipe = JaxRecipe.load(RECIPE)
    recipe = PruneRecipe.load(RECIPE)
    calib = _calibration(cfg.vocab, recipe)
    jrank = jax_profile_model(jparams, jcfg, calib)
    rank = profile_model(params, cfg, calib)
    jart = JaxPipeline(jrecipe).run(jparams, jcfg, rank_artifact=jrank)
    art = MosaicPipeline(recipe).run(params, cfg, rank_artifact=rank)
    dirs = {"jax": str(tmp_path_factory.mktemp("moe-jax")),
            "port": str(tmp_path_factory.mktemp("moe-port"))}
    jart.save(dirs["jax"])
    art.save(dirs["port"])
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                recipe=recipe, jrank=jrank, rank=rank, jart=jart, art=art,
                dirs=dirs)


def test_recipe_matches_jax():
    assert PruneRecipe.load(RECIPE).to_dict() == JaxRecipe.load(
        RECIPE).to_dict()
    r = PruneRecipe.load(RECIPE)
    assert r.group_experts and r.ragged_moe and r.block == 16


def test_expert_anorms_ranks_targets_match_jax(setup):
    jrank, rank = setup["jrank"], setup["rank"]
    assert rank.n_tokens == jrank.n_tokens and rank.weights == jrank.weights
    assert set(rank.anorms) == set(jrank.anorms)
    E = setup["cfg"].layer(0).ffn.n_experts
    assert tuple(rank.anorms[(0, "moe_in")].shape) == (E, 64)
    for k, v in jrank.anorms.items():
        np.testing.assert_allclose(rank.anorms[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
    assert set(rank.rank) == set(jrank.rank)
    for k, v in jrank.rank.items():
        np.testing.assert_allclose(rank.rank[k], v, rtol=1e-4)
    jtargets = setup["jart"].targets
    assert set(setup["art"].targets) == set(jtargets)
    for k, v in jtargets.items():
        np.testing.assert_allclose(setup["art"].targets[k], v, rtol=1e-4)


def test_per_expert_rank_matches_jax(setup):
    anorms = setup["rank"].anorms
    got = pod.global_rank(setup["params"], setup["cfg"], anorms,
                          per_expert=True)
    want = jax_pod.global_rank(setup["jparams"], setup["jcfg"],
                               setup["jrank"].anorms, per_expert=True)
    assert set(got) == set(want)
    E = setup["cfg"].layer(0).ffn.n_experts
    for k, v in want.items():
        assert np.shape(got[k]) == np.shape(v)
        if k[1] in ("gate", "up", "down"):
            assert np.shape(v) == (E,)
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-3)


def test_masks_config_and_expert_plans_equal_jax(setup):
    r = setup["recipe"]
    jtargets = setup["jart"].targets
    anorms, janorms = setup["rank"].anorms, setup["jrank"].anorms
    _, masks = U.prune_unstructured(setup["params"], setup["cfg"], jtargets,
                                    selector=r.selector, anorms=anorms,
                                    block=r.block)
    _, jmasks = jax_U.prune_unstructured(
        setup["jparams"], setup["jcfg"], jtargets, selector=r.selector,
        anorms=janorms, block=r.block)
    assert set(masks) == set(jmasks)
    for k, m in jmasks.items():
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(m))
    assert masks[(0, "up")].dim() == 3
    kw = dict(selector=r.selector, structured_share=r.structured_share,
              align_heads=r.align_heads, align_channels=r.align_channels,
              per_output=r.per_output, block=r.block)
    params, cfg, info = prune_composite(setup["params"], setup["cfg"],
                                        jtargets, anorms=anorms, **kw)
    jparams, jcfg, jinfo = jax_prune_composite(
        setup["jparams"], setup["jcfg"], jtargets, anorms=janorms, **kw)
    assert config_to_dict(cfg) == jax_config_to_dict(jcfg)
    assert cfg.layer(0).ffn.d_ff < setup["cfg"].layer(0).ffn.d_ff
    assert info["unstructured_sparsity"] == jinfo["unstructured_sparsity"]
    got = jax.tree_util.tree_leaves(params_to_numpy(params))
    for a, b in zip(got, jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, np.asarray(b))
    from repro.serve.sparse import pack_model as jax_pack_model
    packed = pack_model(params, cfg, block=r.block, ragged_moe=True)
    jpacked = jax_pack_model(jparams, jcfg, block=r.block, ragged_moe=True)
    assert set(packed) == set(jpacked)
    n_expert = 0
    for k, jp in jpacked.items():
        p = packed[k]
        assert isinstance(p, PackedExpertProjection) == isinstance(
            jp, JaxExpertPlan)
        np.testing.assert_array_equal(p.counts.numpy(), np.asarray(jp.counts))
        np.testing.assert_array_equal(p.indices.numpy(),
                                      np.asarray(jp.indices))
        assert p.density == jp.density
        if isinstance(p, PackedExpertProjection):
            n_expert += 1
            assert p.densities == jp.densities and p.ragged and p.group
    assert n_expert == 3 * cfg.n_layers


def test_pipeline_report_matches_jax(setup):
    art, jart = setup["art"], setup["jart"]
    assert config_to_dict(art.cfg) == jax_config_to_dict(jart.cfg)
    rep, jrep = art.report, jart.report
    for key in ("category", "params_before", "params_after", "bytes_before",
                "bytes_after", "calibration_tokens"):
        assert rep[key] == jrep[key], key
    pk, jpk = rep["pack"], jrep["pack"]
    for key in ("block", "group_experts", "ragged_moe", "quant", "n_packed",
                "n_expert_packed", "packed_params", "skipped"):
        assert pk[key] == jpk[key], key
    assert pk["n_expert_packed"] == 3 * art.cfg.n_layers
    assert abs(flop_savings(art.packed) - jpk["flop_savings"]) < 1e-12


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_bundles_cross_load_with_expert_stacks(setup, saved_by):
    d = setup["dirs"][saved_by]
    art = PrunedArtifact.load(d, device="cpu")
    jart = JaxArtifact.load(d)
    assert config_to_dict(art.cfg) == jax_config_to_dict(jart.cfg)
    assert art.targets == jart.targets
    for (a, b) in zip(jax.tree_util.tree_leaves(params_to_numpy(art.params)),
                      jax.tree_util.tree_leaves(jart.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert set(art.packed) == set(jart.packed)
    for k, jp in jart.packed.items():
        p = art.packed[k]
        assert type(p).__name__ == type(jp).__name__
        np.testing.assert_array_equal(p.counts.numpy(), np.asarray(jp.counts))
        np.testing.assert_array_equal(p.indices.numpy(),
                                      np.asarray(jp.indices))
        if isinstance(p, PackedExpertProjection):
            assert (p.densities, p.group, p.ragged) == (
                jp.densities, jp.group, jp.ragged) and p.ragged


def _prompt(vocab):
    return SyntheticCorpus(vocab, seed=0).batch(0, 3, S0)[:, :S0]


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_static_engine_tokens_equal_jax_on_every_path(setup, saved_by):
    """Greedy tokens of the port's static engine, on the loaded bundle and
    in memory, equal the JAX engine's on the grouped, loop and ragged
    paths and dense."""
    art = PrunedArtifact.load(setup["dirs"][saved_by], device="cpu")
    jart = JaxArtifact.load(setup["dirs"][saved_by])
    prompt = _prompt(art.cfg.vocab)
    base = dict(max_seq=S0 + N_NEW)
    want_dense = np.asarray(JaxEngine.from_artifact(jart, JaxServeConfig(
        compute_dtype=jnp.float32, cache_dtype=jnp.float32, **base),
        sparse=False).generate(jnp.asarray(prompt), N_NEW))
    got_dense = Engine.from_artifact(art, ServeConfig(
        compute_dtype=torch.float32, cache_dtype=torch.float32, **base),
        sparse=False).generate(prompt, N_NEW)
    np.testing.assert_array_equal(got_dense.numpy(), want_dense)
    mem = setup["art"] if saved_by == "port" else None
    for name, kw in PATHS.items():
        jserve = JaxServeConfig(compute_dtype=jnp.float32,
                                cache_dtype=jnp.float32, **base, **kw)
        serve = ServeConfig(compute_dtype=torch.float32,
                            cache_dtype=torch.float32, **base, **kw)
        want = np.asarray(JaxEngine.from_artifact(jart, jserve).generate(
            jnp.asarray(prompt), N_NEW))
        counters.reset()
        for a in (art, mem) if mem is not None else (art,):
            got = Engine.from_artifact(a, serve).generate(prompt, N_NEW)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=name)
        assert counters.snapshot() == {}, "CPU runs launch no kernel"


CONTINUOUS = {"contiguous": {}, "paged-kernel": {"block_size": 8,
                                                 "paged_kernel": True}}


@pytest.mark.parametrize("pool", sorted(CONTINUOUS))
def test_continuous_engine_tokens_equal_jax_on_every_path(setup, pool):
    """Mixed requests on the continuous engine: the port's tokens equal
    the JAX engine's on each MoE path, from the port's bundle and in
    memory."""
    d = setup["dirs"]["port"]
    art = PrunedArtifact.load(d, device="cpu")
    jart = JaxArtifact.load(d)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, art.cfg.vocab, (n,)).tolist()
               for n in (5, 9, 7, 12)]

    def reqs(R):
        return [R(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]

    base = dict(max_slots=2, max_seq=32, prefill_multiple=4,
                **CONTINUOUS[pool])
    for name, kw in PATHS.items():
        jeng = JaxContinuousEngine.from_artifact(jart, JaxServeConfig(
            compute_dtype=jnp.float32, cache_dtype=jnp.float32, **base,
            **kw))
        want, _ = jeng.run(reqs(JaxRequest))
        want = {f.request.uid: f.tokens for f in want}
        serve = ServeConfig(compute_dtype=torch.float32,
                            cache_dtype=torch.float32, **base, **kw)
        for a in (art, setup["art"]):
            got, _ = ContinuousEngine.from_artifact(a, serve).run(
                reqs(Request))
            assert {f.request.uid: f.tokens for f in got} == want, name


def test_moe_cli_prunes_and_serves_on_cpu(tmp_path):
    """The launchers' MoE path on the CPU: prune with the recipe, then
    serve the bundle with ragged decode on both engines."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = str(tmp_path / "moe")

    def run(*args):
        proc = subprocess.run([sys.executable, "-m", *args, "--device",
                               "cpu"], cwd=REPO, env=env,
                              capture_output=True, text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    assert "saved PrunedArtifact" in run(
        "repro_torch.launch.prune", "--smoke", "--recipe", RECIPE, "--out",
        out)
    s = run("repro_torch.launch.serve", "--smoke", "--artifact", out,
            "--sparse", "--ragged-moe")
    assert "6 saved plans" in s and "generated (4, 64)" in s
    s = run("repro_torch.launch.serve", "--smoke", "--artifact", out,
            "--sparse", "--no-group-experts", "--engine", "continuous",
            "--block-size", "16", "--paged-kernel")
    assert "served 4 requests" in s
    assert JaxArtifact.load(out).report["pack"]["ragged_moe"] is True
