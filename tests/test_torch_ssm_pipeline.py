"""The SSM/hybrid slice end to end against the JAX package, at f32 on the
CPU: jamba-v0.1-52b at smoke size (attention, Mamba, MLP and MoE layers
in one stack) pruned with a composite ``wanda_block`` recipe at block 16
(``recipes/moe-smoke.json`` with its ``arch`` set to jamba).

Both packages start from the same params (JAX ``init_model``, through
numpy) and the same calibration tokens. Activation norms, POD ranks and
targets agree within a tolerance; given JAX's targets, the masks, the
SSD heads ``prune_mamba`` keeps, the pruned params and config, the plans
and the list of non-tileable projections are equal. Bundles cross-load
both ways, and the static and continuous engines give the JAX engines'
greedy tokens. The continuous engine's two hybrid rules (unpadded
prefills, no paged pool) raise as JAX's do.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
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
from repro.serve.sparse import pack_model_with_report as jax_pack_report
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core import unstructured as U
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.composite import prune_composite
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import profile_model
from repro_torch.core.recipe import PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels import counters
from repro_torch.models import transformer as T
from repro_torch.models.specs import (MambaSpec, config_from_dict,
                                      config_to_dict)
from repro_torch.serve.batching import ContinuousEngine
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.scheduler import Request
from repro_torch.serve.sparse import flop_savings, pack_model_with_report

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "moe-smoke.json")
ARCH = "jamba-v0.1-52b"
CPU = torch.device("cpu")
S0, N_NEW = 10, 8
F32 = dict(compute_dtype=torch.float32, cache_dtype=torch.float32)
JF32 = dict(compute_dtype=jnp.float32, cache_dtype=jnp.float32)


def _recipes():
    return (JaxRecipe.load(RECIPE).replace(arch=ARCH),
            PruneRecipe.load(RECIPE).replace(arch=ARCH))


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg = jax_get_smoke_config(ARCH).replace(scan_layers=False)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    jrecipe, recipe = _recipes()
    c = recipe.calibration
    calib = SyntheticCorpus(cfg.vocab, seed=c.seed).calibration_batches(
        c.n_samples, c.batch_size, c.seq_len)
    jrank = jax_profile_model(jparams, jcfg, calib)
    rank = profile_model(params, cfg, calib)
    jart = JaxPipeline(jrecipe).run(jparams, jcfg, rank_artifact=jrank)
    art = MosaicPipeline(recipe).run(params, cfg, rank_artifact=rank)
    dirs = {"jax": str(tmp_path_factory.mktemp("ssm-jax")),
            "port": str(tmp_path_factory.mktemp("ssm-port"))}
    jart.save(dirs["jax"])
    art.save(dirs["port"])
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                recipe=recipe, jrank=jrank, rank=rank, jart=jart, art=art,
                dirs=dirs)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", ARCH])
@pytest.mark.parametrize("smoke", [False, True])
def test_config_dicts_match_jax(arch, smoke):
    if smoke:
        cfg, jcfg = get_smoke_config(arch), jax_get_smoke_config(arch)
    else:
        cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert config_to_dict(cfg) == jax_config_to_dict(jcfg)
    assert config_from_dict(config_to_dict(cfg)) == cfg
    m = next(s.mixer for s in cfg.layers() if isinstance(s.mixer,
                                                         MambaSpec))
    jm = next(s.mixer for s in jcfg.layers()
              if type(s.mixer).__name__ == "MambaSpec")
    assert (m.n_heads, m.conv_dim, m.in_dim) == (jm.n_heads, jm.conv_dim,
                                                jm.in_dim)


def test_anorms_ranks_targets_match_jax(setup):
    jrank, rank = setup["jrank"], setup["rank"]
    assert rank.n_tokens == jrank.n_tokens and rank.weights == jrank.weights
    assert set(rank.anorms) == set(jrank.anorms)
    assert (0, "mamba_in") in rank.anorms and (0, "mamba_out") in rank.anorms
    for k, v in jrank.anorms.items():
        np.testing.assert_allclose(rank.anorms[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
    assert set(rank.rank) == set(jrank.rank)
    for k, v in jrank.rank.items():
        np.testing.assert_allclose(rank.rank[k], v, rtol=1e-4)
    jtargets = setup["jart"].targets
    assert set(setup["art"].targets) == set(jtargets)
    assert (0, "in_proj") in jtargets
    for k, v in jtargets.items():
        np.testing.assert_allclose(setup["art"].targets[k], v, rtol=1e-4)


def test_masks_heads_params_and_plans_equal_jax(setup):
    r = setup["recipe"]
    jtargets = setup["jart"].targets
    anorms, janorms = setup["rank"].anorms, setup["jrank"].anorms
    _, masks = U.prune_unstructured(setup["params"], setup["cfg"], jtargets,
                                    selector=r.selector, anorms=anorms,
                                    block=r.block)
    _, jmasks = jax_U.prune_unstructured(
        setup["jparams"], setup["jcfg"], jtargets, selector=r.selector,
        anorms=janorms, block=r.block)
    assert set(masks) == set(jmasks) and (0, "in_proj") in masks
    for k, m in jmasks.items():
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(m))
    kw = dict(selector=r.selector, structured_share=r.structured_share,
              align_heads=r.align_heads, align_channels=r.align_channels,
              per_output=r.per_output, block=r.block)
    params, cfg, info = prune_composite(setup["params"], setup["cfg"],
                                        jtargets, anorms=anorms, **kw)
    jparams, jcfg, jinfo = jax_prune_composite(
        setup["jparams"], setup["jcfg"], jtargets, anorms=janorms, **kw)
    assert config_to_dict(cfg) == jax_config_to_dict(jcfg)
    kept = [s.mixer.d_inner for s in cfg.layers()
            if isinstance(s.mixer, MambaSpec)]
    full = setup["cfg"].layer(0).mixer.d_inner
    assert kept and all(k < full for k in kept), "heads were removed"
    assert info["unstructured_sparsity"] == jinfo["unstructured_sparsity"]
    assert info["structured_fractions"] == jinfo["structured_fractions"]
    got = jax.tree_util.tree_leaves(params_to_numpy(params))
    want = jax.tree_util.tree_leaves(jparams)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
    packed, rep = pack_model_with_report(params, cfg, block=r.block,
                                         ragged_moe=True)
    jpacked, jrep = jax_pack_report(jparams, jcfg, block=r.block,
                                    ragged_moe=True)
    assert set(packed) == set(jpacked)
    assert (0, "out_proj") in packed
    for k, jp in jpacked.items():
        np.testing.assert_array_equal(packed[k].counts.numpy(),
                                      np.asarray(jp.counts))
        np.testing.assert_array_equal(packed[k].indices.numpy(),
                                      np.asarray(jp.indices))
        assert packed[k].density == jp.density
    assert rep["skipped"] == jrep["skipped"]
    # in_dim = 2 di + 2 N + H is tileable by 16 only when 16 divides H
    assert {s["name"] for s in rep["skipped"]} >= {"in_proj"}
    assert abs(rep["flop_savings"] - jrep["flop_savings"]) < 1e-12


def test_pipeline_report_matches_jax(setup):
    art, jart = setup["art"], setup["jart"]
    assert config_to_dict(art.cfg) == jax_config_to_dict(jart.cfg)
    rep, jrep = art.report, jart.report
    for key in ("category", "params_before", "params_after", "bytes_before",
                "bytes_after", "calibration_tokens"):
        assert rep[key] == jrep[key], key
    pk, jpk = rep["pack"], jrep["pack"]
    for key in ("block", "n_packed", "n_expert_packed", "packed_params",
                "n_skipped", "skipped"):
        assert pk[key] == jpk[key], key
    assert abs(flop_savings(art.packed) - jpk["flop_savings"]) < 1e-12


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_bundles_cross_load_with_mamba_leaves(setup, saved_by):
    d = setup["dirs"][saved_by]
    art = PrunedArtifact.load(d, device="cpu")
    jart = JaxArtifact.load(d)
    assert config_to_dict(art.cfg) == jax_config_to_dict(jart.cfg)
    assert art.targets == jart.targets
    m = art.params["blocks"][0]["mamba"]
    assert {k for k in m} == {"in_proj", "conv_w", "conv_b", "A_log", "D",
                              "dt_bias", "norm_scale", "out_proj"}
    assert all(m[k].dtype == torch.float32 for k in ("A_log", "D",
                                                     "dt_bias"))
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(art.params)),
                    jax.tree_util.tree_leaves(jart.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert set(art.packed) == set(jart.packed)
    for k, jp in jart.packed.items():
        np.testing.assert_array_equal(art.packed[k].counts.numpy(),
                                      np.asarray(jp.counts))


def _prompt(vocab):
    return SyntheticCorpus(vocab, seed=0).batch(0, 3, S0)[:, :S0]


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_static_engine_tokens_equal_jax(setup, saved_by):
    """Greedy tokens of the port's static engine on the loaded bundle,
    sparse (kernels' plain versions on the CPU) and dense, equal the JAX
    engine's."""
    art = PrunedArtifact.load(setup["dirs"][saved_by], device="cpu")
    jart = JaxArtifact.load(setup["dirs"][saved_by])
    prompt = _prompt(art.cfg.vocab)
    base = dict(max_seq=S0 + N_NEW)
    counters.reset()
    for sparse in (False, True):
        want = np.asarray(JaxEngine.from_artifact(
            jart, JaxServeConfig(**JF32, **base), sparse=sparse).generate(
                jnp.asarray(prompt), N_NEW))
        got = Engine.from_artifact(art, ServeConfig(**F32, **base),
                                   sparse=sparse).generate(prompt, N_NEW)
        np.testing.assert_array_equal(got.numpy(), want)
    assert counters.snapshot() == {}, "CPU runs launch no kernel"


def test_continuous_engine_tokens_equal_jax(setup):
    """Mixed requests on the contiguous pool with unpadded prefills: the
    port's tokens equal the JAX engine's, sparse and dense, and each
    request's tokens equal that request served alone by the static
    engine."""
    art = PrunedArtifact.load(setup["dirs"]["port"], device="cpu")
    jart = JaxArtifact.load(setup["dirs"]["port"])
    rng = np.random.default_rng(2)
    prompts = [rng.integers(1, art.cfg.vocab, (n,)).tolist()
               for n in (5, 9, 7, 12, 3)]

    def reqs(R):
        return [R(uid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]

    base = dict(max_slots=2, max_seq=32, prefill_multiple=1)
    for sparse in (True, False):
        jeng = JaxContinuousEngine.from_artifact(
            jart, JaxServeConfig(**JF32, **base), sparse=sparse)
        want, _ = jeng.run(reqs(JaxRequest))
        want = {f.request.uid: f.tokens for f in want}
        got, _ = ContinuousEngine.from_artifact(
            art, ServeConfig(**F32, **base), sparse=sparse).run(
                reqs(Request))
        assert {f.request.uid: f.tokens for f in got} == want
    eng = Engine.from_artifact(art, ServeConfig(**F32, max_seq=32))
    for f in got:
        alone = eng.generate(np.asarray([f.request.prompt]), 6)
        assert alone[0, len(f.request.prompt):].tolist() == f.tokens


def _hybrid(seed=0):
    jcfg = small_config(mamba=True)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax_T.init_model(jax.random.PRNGKey(seed), jcfg)
    return cfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), CPU)


def test_continuous_hybrid_needs_unpadded_prefill():
    """The port of the JAX test of the same name: padded prefills would
    integrate pad tokens into the SSM state, so a hybrid config is
    refused unless ``prefill_multiple=1``, and then the continuous engine
    matches the static engine."""
    cfg, params = _hybrid()
    with pytest.raises(ValueError, match="unpadded prefills"):
        ContinuousEngine(params, cfg, ServeConfig(max_slots=2, max_seq=32))
    ce = ContinuousEngine(params, cfg, ServeConfig(
        max_slots=2, max_seq=32, prefill_multiple=1, **F32))
    eng = Engine(params, cfg, ServeConfig(max_seq=32, **F32))
    rng = np.random.default_rng(3)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, (n,)).tolist(),
                    max_new_tokens=5)
            for i, n in enumerate([6, 9])]
    finished, _ = ce.run(reqs)
    for f in finished:
        p = np.asarray([f.request.prompt])
        ref = eng.generate(p, 5)[0, p.shape[1]:].tolist()
        assert f.tokens == ref, f"uid {f.request.uid} diverged"


def test_paged_rejects_hybrid_configs():
    """The port of the JAX paged test of the same name."""
    cfg, params = _hybrid()
    with pytest.raises(ValueError, match="attention-only"):
        ContinuousEngine(params, cfg,
                         ServeConfig(max_slots=2, max_seq=32, block_size=8,
                                     prefill_multiple=1))


def test_mamba_cli_prunes_and_serves_on_cpu(tmp_path):
    """The launchers on mamba2-1.3b at smoke size: prune with the
    composite ``wanda_block`` flags, serve the bundle on the static
    engine; the JAX launcher serves it to the same sample tokens."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = str(tmp_path / "ssm")

    def run(*args):
        proc = subprocess.run([sys.executable, "-m", *args], cwd=REPO,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    s = run("repro_torch.launch.prune", "--arch", "mamba2-1.3b", "--smoke",
            "--p", "0.5", "--category", "composite", "--selector",
            "wanda_block", "--block", "16", "--out", out, "--device", "cpu")
    assert "saved PrunedArtifact" in s and "1 skipped" in s
    s = run("repro_torch.launch.serve", "--smoke", "--artifact", out,
            "--device", "cpu")
    assert "generated (4, 64)" in s
    sample = [ln for ln in s.splitlines() if ln.startswith("sample:")]
    j = run("repro.launch.serve", "--smoke", "--artifact", out)
    assert sample and sample[0] in j.splitlines()
