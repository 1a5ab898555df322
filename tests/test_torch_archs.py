"""Every architecture of the registry against the JAX package, at f32.

The port of ``tests/test_archs_smoke.py`` and of
``tests/test_models.py::test_frontend_embeds_replace_prefix``. For each
of the eleven ids, the smoke config's params are made by JAX
``init_model`` (scanned, as JAX stores them), handed over through numpy
and unstacked (``common/interop.py``); tokens and frontend embeddings
are made with numpy. Held to JAX: the config dicts, the full config's
parameter count, the forward's logits (with ``frontend_embeds`` where
the config has a frontend), a prefill and a decode step through the
cache, and the train step's loss. JAX-written smoke bundles of the new
dense and frontend archs serve in the port to JAX's greedy tokens, and
a port-written one in JAX. llama4-scout cannot be profiled in either
package (its shared expert's taps are not in the tap sequence); its
sparse serve over plans packed from the unpruned params gives JAX's
tokens.
"""
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as JAX_ARCHS
from repro.configs.registry import get_config as jax_get_config
from repro.configs.registry import get_smoke_config as jax_get_smoke_config
from repro.core.artifact import PrunedArtifact as JaxArtifact
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.rank_controller import profile_model as jax_profile_model
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import make_prefill_step as jax_make_prefill_step
from repro.serve.sparse import pack_model as jax_pack_model
from repro.train import optimizer as JOPT
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.common.interop import params_from_numpy, unstack_blocks
from repro_torch.common.tree import param_count, tree_map
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import profile_model
from repro_torch.core.recipe import PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict, config_to_dict
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine, make_prefill_step
from repro_torch.serve.sparse import pack_model
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import make_train_step

ATOL = 1e-4          # f32 logits: matmul and softmax summation order
LOSS_RTOL = 1e-5
CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")
B, S, F, S_MAX = 2, 16, 4, 24        # F frontend positions of S
BUNDLE_ARCHS = ("gemma-2b", "musicgen-large", "nemotron-4-340b",
                "qwen2-vl-2b")
S0, N_NEW = 10, 8                    # bundle serving: prompt, new tokens


@pytest.fixture(scope="module")
def models():
    """{arch: (jax cfg, port cfg (unrolled), jax params, port params)},
    built on first use."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg = jax_get_smoke_config(arch)
            jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
            host = jax.tree_util.tree_map(np.asarray, jparams)
            params = params_from_numpy(host, CPU)
            params["blocks"] = unstack_blocks(params["blocks"],
                                              jcfg.n_periods)
            cfg = config_from_dict(jax_config_to_dict(jcfg)).replace(
                scan_layers=False)
            cache[arch] = (jcfg, cfg, jparams, params)
        return cache[arch]
    return get


def _inputs(cfg, seed: int = 0):
    """tokens and labels (B, S) and, for a frontend config, embeddings
    (B, F, d)."""
    rng = np.random.default_rng(seed)
    toks, labels = rng.integers(0, cfg.vocab, (2, B, S)).astype(np.int32)
    fe = (rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)
          if cfg.frontend else None)
    return toks, labels, fe


def _jax_unrolled(jcfg, jparams):
    """JAX's scanned smoke params and config as the unrolled ones its
    launchers prune and serve (layer i: slot i % P, period i // P)."""
    P = len(jcfg.pattern)
    blocks = [jax.tree_util.tree_map(lambda x, t=i // P: x[t],
                                     jparams["blocks"][i % P])
              for i in range(jcfg.n_layers)]
    return jcfg.unrolled(), dict(jparams, blocks=blocks)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def test_registry_matches_jax():
    assert set(ARCHS) == set(JAX_ARCHS) and len(ARCHS) == 11


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_config_and_param_count_match_jax(arch):
    """Full and smoke configs equal JAX's as dicts; the full config's
    parameter count from a meta init equals JAX's ``eval_shape`` count."""
    full, jfull = get_config(arch), jax_get_config(arch)
    assert json.dumps(config_to_dict(full), sort_keys=True) == \
        json.dumps(jax_config_to_dict(jfull), sort_keys=True)
    assert config_to_dict(get_smoke_config(arch)) == jax_config_to_dict(
        jax_get_smoke_config(arch))
    shapes = jax.eval_shape(
        lambda: jax_T.init_model(jax.random.PRNGKey(0), jfull, jnp.bfloat16))
    want = sum(math.prod(x.shape) for x in jax.tree.leaves(shapes))
    meta = T.init_model(None, full.replace(scan_layers=False))
    assert param_count(meta) == want > 1e9
    assert full.padded_vocab % full.vocab_pad_multiple == 0


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_forward_decode_and_train_step_match_jax(models, arch):
    jcfg, cfg, jparams, params = models(arch)
    toks, labels, fe = _inputs(cfg)
    # the forward, frontend embeddings over the first F positions
    want_fwd, _, jaux = jax_T.forward(jparams, jcfg, jnp.asarray(toks),
                                      frontend_embeds=fe,
                                      compute_dtype=jnp.float32)
    got, _, aux = T.forward(params, cfg, _t(toks), frontend_embeds=_t(fe),
                            compute_dtype=torch.float32)
    assert got.shape == (B, S, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_fwd),
                               atol=ATOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-7)

    # a prefill through the cache, then one decode step
    jcache = jax_T.init_cache(jcfg, B, S_MAX, dtype=jnp.float32)
    cache = T.init_cache(cfg, B, S_MAX, torch.float32)
    _, jcache = jax_make_prefill_step(jcfg, jnp.float32)(
        jparams, jnp.asarray(toks), jcache, fe)
    pre, cache = make_prefill_step(cfg, torch.float32)(
        params, _t(toks), cache, _t(fe))
    np.testing.assert_allclose(pre.numpy(), got.numpy(), atol=ATOL)
    step = toks[:, :1]
    want, _, _ = jax_T.forward(jparams, jcfg, jnp.asarray(step),
                               cache=jcache, cache_index=jnp.int32(S),
                               compute_dtype=jnp.float32)
    got, _, _ = T.forward(params, cfg, _t(step), cache=cache,
                          cache_index=S, compute_dtype=torch.float32)
    assert got.shape == (B, 1, cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)

    # the train step's loss: the loss before its update, as JAX's
    # make_train_step reports it (JAX's loss_fn: the cross-entropy of the
    # forward's logits plus 0.01 x its aux loss)
    jloss = float(jax_T.cross_entropy(want_fwd, jnp.asarray(labels),
                                      jcfg.vocab)) + 0.01 * float(jaux)
    opt_cfg = OPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mine = tree_map(torch.clone, params)     # the step updates in place
    state = {"params": mine, "opt": OPT.init_opt(mine, opt_cfg)}
    state, metrics = make_train_step(cfg, opt_cfg,
                                     compute_dtype=torch.float32)(
        state, _t(toks), _t(labels), _t(fe))
    assert abs(float(metrics["loss"]) - float(jloss)) <= \
        LOSS_RTOL * abs(float(jloss))
    assert not torch.equal(mine["embed"]["table"],
                           params["embed"]["table"])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b"])
def test_microbatched_train_step_with_frontend_matches_jax(models, arch):
    """Two microbatches split the frontend embeddings on the batch axis
    as JAX's scan over microbatches does: the loss, and the params after
    one AdamW update, match JAX's jitted train step."""
    jcfg, cfg, jparams, _ = models(arch)
    x, y, fe_t = _inputs(cfg, seed=1)
    opt_cfg = OPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jopt = JOPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt, n_microbatches=2,
                                        compute_dtype=jnp.float32))
    jstate, jm = jstep({"params": jparams,
                        "opt": JOPT.init_opt(jparams, jopt)},
                       jnp.asarray(x), jnp.asarray(y), jnp.asarray(fe_t))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    params["blocks"] = unstack_blocks(params["blocks"], jcfg.n_periods)
    state = {"params": params, "opt": OPT.init_opt(params, opt_cfg)}
    state, m = make_train_step(cfg, opt_cfg, n_microbatches=2,
                               compute_dtype=torch.float32)(
        state, _t(x), _t(y), _t(fe_t))
    assert abs(float(m["loss"]) - float(jm["loss"])) <= \
        LOSS_RTOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(
        state["params"]["embed"]["table"].numpy(),
        np.asarray(jstate["params"]["embed"]["table"]), atol=1e-6)
    jup = np.asarray(jstate["params"]["blocks"][0]["mlp"]["up"])[0]
    np.testing.assert_allclose(
        state["params"]["blocks"][0]["mlp"]["up"].numpy(), jup, atol=1e-6)


def test_frontend_embeds_replace_prefix(models):
    """The port of the JAX test of the same name: embeddings over the
    first F positions change the logits; the tokens under them do not."""
    _, cfg, _, params = models("qwen2-vl-2b")
    toks, _, fe = _inputs(cfg, seed=2)
    lo1, _, _ = T.forward(params, cfg, _t(toks), frontend_embeds=_t(fe),
                          compute_dtype=torch.float32)
    lo2, _, _ = T.forward(params, cfg, _t(toks), compute_dtype=torch.float32)
    assert lo1.shape == lo2.shape and bool((lo1 != lo2).any())
    swapped = toks.copy()
    swapped[:, :F] = (swapped[:, :F] + 1) % cfg.vocab
    lo3, _, _ = T.forward(params, cfg, _t(swapped), frontend_embeds=_t(fe),
                          compute_dtype=torch.float32)
    assert torch.equal(lo3, lo1)


# ---------------------------------------------------------------- bundles

def _recipe(arch: str) -> dict:
    d = json.load(open(RECIPE))
    d["arch"] = arch
    return d


@pytest.fixture(scope="module")
def jax_bundles(tmp_path_factory, models):
    """{arch: dir}: the golden-smoke recipe (its arch replaced) run by
    the JAX pipeline on the smoke params, and saved."""
    out = {}
    for arch in BUNDLE_ARCHS:
        jcfg, jparams = _jax_unrolled(*models(arch)[::2])
        d = str(tmp_path_factory.mktemp(f"bundle-{arch}"))
        JaxPipeline(JaxRecipe.from_dict(_recipe(arch))).run(
            jparams, jcfg).save(d)
        out[arch] = d
    return out


def _serve_both(art, jart, sparse: bool):
    prompt = SyntheticCorpus(art.cfg.vocab, seed=0).batch(0, 3, S0)[:, :S0]
    jserve = JaxServeConfig(max_seq=S0 + N_NEW, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
    serve = ServeConfig(max_seq=S0 + N_NEW, compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    want = np.asarray(JaxEngine.from_artifact(jart, jserve, sparse=sparse)
                      .generate(jnp.asarray(prompt), N_NEW))
    got = Engine.from_artifact(art, serve, sparse=sparse).generate(
        prompt, N_NEW)
    return np.asarray(got), want


@pytest.mark.parametrize("arch", BUNDLE_ARCHS)
def test_jax_bundle_serves_jax_tokens_in_port(jax_bundles, arch):
    art = PrunedArtifact.load(jax_bundles[arch], device="cpu")
    jart = JaxArtifact.load(jax_bundles[arch])
    assert config_to_dict(art.cfg) == jax_config_to_dict(jart.cfg)
    assert art.packed and set(art.packed) == set(jart.packed)
    got, want = _serve_both(art, jart, sparse=True)
    np.testing.assert_array_equal(got, want)


def test_port_bundle_loads_and_serves_in_jax(models, jax_bundles, tmp_path):
    """The port prunes gemma-2b's smoke params with the same recipe: the
    bundle loads in JAX with JAX's own bundle's params and plans, and
    serves the same greedy tokens dense and sparse."""
    _, cfg, _, params = models("gemma-2b")
    MosaicPipeline(PruneRecipe.from_dict(_recipe("gemma-2b"))).run(
        params, cfg).save(str(tmp_path))
    jart = JaxArtifact.load(str(tmp_path))
    jref = JaxArtifact.load(jax_bundles["gemma-2b"])
    assert jax_config_to_dict(jart.cfg) == jax_config_to_dict(jref.cfg)
    for a, b in zip(jax.tree.leaves(jart.params), jax.tree.leaves(
            jref.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert set(jart.packed) == set(jref.packed)
    art = PrunedArtifact.load(str(tmp_path), device="cpu")
    for sparse in (False, True):
        got, want = _serve_both(art, jart, sparse)
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------- llama4-scout

def test_llama4_scout_profile_refused_in_both(models):
    """The shared expert's MLP records taps the tap sequence does not
    list: JAX's calibration asserts, and the port's raises in the same
    place."""
    jcfg, cfg, jparams, params = models("llama4-scout-17b-16e")
    calib = SyntheticCorpus(cfg.vocab, seed=0).calibration_batches(2, 2, 8)
    with pytest.raises(AssertionError, match="unconsumed taps"):
        jax_profile_model(*_jax_unrolled(jcfg, jparams)[::-1], calib)
    with pytest.raises(RuntimeError, match="unconsumed taps"):
        profile_model(params, cfg, calib)


@pytest.mark.parametrize("ragged", [False, True])
def test_llama4_scout_sparse_serve_over_dense_plans_matches_jax(models,
                                                                 ragged):
    """Plans packed from the unpruned params (JAX's ``launch/serve.py
    --sparse``): the grouped and the ragged dispatch, with the shared
    expert dense, give JAX's greedy tokens and the dense engine's."""
    jcfg, cfg, jparams, params = models("llama4-scout-17b-16e")
    junrolled, jflat = _jax_unrolled(jcfg, jparams)
    jpacked = jax_pack_model(jflat, junrolled, block=16, ragged_moe=ragged)
    packed = pack_model(params, cfg, block=16, ragged_moe=ragged)
    assert set(packed) == set(jpacked) and len(packed) == 6
    prompt = SyntheticCorpus(cfg.vocab, seed=0).batch(0, 3, S0)[:, :S0]
    jserve = JaxServeConfig(max_seq=S0 + N_NEW, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
    want = np.asarray(JaxEngine(jflat, junrolled, jserve, packed=jpacked)
                      .generate(jnp.asarray(prompt), N_NEW))
    serve = ServeConfig(max_seq=S0 + N_NEW, compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    got = Engine(params, cfg, serve, packed=packed).generate(prompt, N_NEW)
    dense = Engine(params, cfg, serve).generate(prompt, N_NEW)
    np.testing.assert_array_equal(np.asarray(got), want)
    np.testing.assert_array_equal(np.asarray(dense), want)
