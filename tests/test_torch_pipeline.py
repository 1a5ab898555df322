"""The port's pruning pipeline against the JAX package,
on the golden-smoke recipe at small size (f32).

Both packages start from the same params (JAX ``init_model``, through
numpy) and the same calibration tokens. Activation norms, POD ranks and
targets agree within a tolerance (the sums run in another order); JAX's
targets are then fed to the port's prune step so that masks, the pruned
config and the block plans can be held equal exactly. Serving is held
to the JAX engine in ``test_torch_serve.py``.
"""
import os

import numpy as np
import pytest
import torch

import jax
from repro.core import unstructured as jax_U
from repro.core.composite import prune_composite as jax_prune_composite
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.rank_controller import profile_model as jax_profile_model
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.data.pipeline import SyntheticCorpus as JaxCorpus
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.sparse import pack_model as jax_pack_model
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.core import unstructured as U
from repro_torch.core.composite import prune_composite
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import profile_model
from repro_torch.core.recipe import PruneRecipe
from repro_torch.core.registry import STAGES, projections, tap_sequence
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models.specs import config_from_dict, config_to_dict
from repro_torch.serve.sparse import flop_savings, pack_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")
CPU = torch.device("cpu")


def _calibration(vocab, recipe):
    c = recipe.calibration
    return SyntheticCorpus(vocab, seed=c.seed).calibration_batches(
        c.n_samples, c.batch_size, c.seq_len)


@pytest.fixture(scope="module")
def setup():
    jcfg = small_config()
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
    return dict(jcfg=jcfg, cfg=cfg, jparams=jparams, params=params,
                jrecipe=jrecipe, recipe=recipe, jrank=jrank, rank=rank,
                jart=jart, art=art)


def test_corpus_and_recipe_match_jax():
    a = SyntheticCorpus(256, seed=3).calibration_batches(8, 4, 16)
    b = JaxCorpus(256, seed=3).calibration_batches(8, 4, 16)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert PruneRecipe.load(RECIPE).to_dict() == JaxRecipe.load(
        RECIPE).to_dict()
    assert STAGES.names() == ["evaluate", "pack", "plan", "prune", "rank",
                              "report"]


def test_registry_matches_jax():
    from repro.core.registry import projections as jax_projections
    from repro.core.registry import tap_sequence as jax_tap_sequence
    jcfg = small_config()
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    assert ([tuple(vars(p).values()) for p in projections(cfg)]
            == [tuple(vars(p).values()) for p in jax_projections(jcfg)])
    assert tap_sequence(cfg.layer(0)) == jax_tap_sequence(jcfg.layer(0))


def test_anorms_ranks_targets_match_jax(setup):
    jrank, rank = setup["jrank"], setup["rank"]
    assert rank.n_tokens == jrank.n_tokens
    assert rank.weights == jrank.weights
    assert set(rank.anorms) == set(jrank.anorms)
    for k, v in jrank.anorms.items():
        np.testing.assert_allclose(rank.anorms[k].numpy(), np.asarray(v),
                                   rtol=1e-5, atol=1e-6)
    assert set(rank.rank) == set(jrank.rank)
    for k, v in jrank.rank.items():
        np.testing.assert_allclose(rank.rank[k], v, rtol=1e-4)
    targets = MosaicPipeline(setup["recipe"], stages=("plan",)).run(
        setup["params"], setup["cfg"], rank_artifact=rank).targets
    jtargets = setup["jart"].targets
    assert set(targets) == set(jtargets)
    for k, v in jtargets.items():
        np.testing.assert_allclose(targets[k], v, rtol=1e-4)


def test_masks_config_and_plans_equal_jax_given_jax_targets(setup):
    r = setup["recipe"]
    jtargets = setup["jart"].targets
    anorms = setup["rank"].anorms
    _, masks = U.prune_unstructured(setup["params"], setup["cfg"], jtargets,
                                    selector=r.selector, anorms=anorms,
                                    block=r.block)
    _, jmasks = jax_U.prune_unstructured(
        setup["jparams"], setup["jcfg"], jtargets, selector=r.selector,
        anorms=setup["jrank"].anorms, block=r.block)
    assert set(masks) == set(jmasks)
    for k, m in jmasks.items():
        np.testing.assert_array_equal(masks[k].numpy(), np.asarray(m))

    kw = dict(selector=r.selector, structured_share=r.structured_share,
              align_heads=r.align_heads, align_channels=r.align_channels,
              per_output=r.per_output, block=r.block)
    params, cfg, info = prune_composite(setup["params"], setup["cfg"],
                                        jtargets, anorms=anorms, **kw)
    jparams, jcfg, jinfo = jax_prune_composite(
        setup["jparams"], setup["jcfg"], jtargets,
        anorms=setup["jrank"].anorms, **kw)
    assert config_to_dict(cfg) == jax_config_to_dict(jcfg)
    assert info["unstructured_sparsity"] == jinfo["unstructured_sparsity"]
    for a, b in zip(jax.tree_util.tree_leaves(params_to_numpy(params)),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a != 0, np.asarray(b) != 0)

    packed = pack_model(params, cfg, block=r.block)
    jpacked = jax_pack_model(jparams, jcfg, block=r.block)
    assert set(packed) == set(jpacked) and packed
    for k, p in jpacked.items():
        np.testing.assert_array_equal(packed[k].counts.numpy(),
                                      np.asarray(p.counts))
        np.testing.assert_array_equal(packed[k].indices.numpy(),
                                      np.asarray(p.indices))
        assert packed[k].density == p.density
        assert packed[k].counts.dtype == torch.int32


def test_pipeline_report_and_skips(setup):
    art, jart = setup["art"], setup["jart"]
    assert config_to_dict(art.cfg) == jax_config_to_dict(jart.cfg)
    rep, jrep = art.report, jart.report
    for key in ("category", "params_before", "params_after", "bytes_before",
                "bytes_after", "calibration_tokens"):
        assert rep[key] is not None, key
        assert rep[key] == jrep[key], key
    assert rep["pack"]["skipped"] == jrep["pack"]["skipped"]
    assert rep["pack"]["n_packed"] == jrep["pack"]["n_packed"]
    assert abs(flop_savings(art.packed) - jrep["pack"]["flop_savings"]) \
        < 1e-12
    assert all(s["reason"] == "non-tileable" for s in rep["pack"]["skipped"])
