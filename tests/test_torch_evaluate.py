"""The port's evaluate stage against the JAX package, at small size on
the CPU (f32), on the same params (JAX ``init_model`` through numpy) and
the same held-out tokens (both draw them with numpy from the synthetic
corpus).

Tolerances: cross-entropy and perplexity within 1e-5 relative (the
forwards sum in another order); top-1 and top-5 accuracy equal except
for tokens whose label logit lies within 1e-5 of the k-th largest (a
near tie the two forwards may order differently). The platform presets
resolve to the same category and targets in both packages.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import evaluate as jax_EV
from repro.core import planner as jax_PL
from repro.core import prune_controller as jax_PC
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.core.registry import STAGES as JAX_STAGES
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy
from repro_torch.core import evaluate as EV
from repro_torch.core import planner as PL
from repro_torch.core import prune_controller as PC
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.recipe import PruneRecipe
from repro_torch.core.registry import STAGES
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")
CPU = torch.device("cpu")
PPL_RTOL = 1e-5
TIE_ATOL = 1e-5
EVAL_STAGES = ("rank", "plan", "prune", "evaluate", "report")
SPEC = jax_EV.EvalSpec(batch_size=2, seq_len=16, n_ppl=2, n_acc=2)


def _model(moe: bool):
    jcfg = small_config(moe=moe)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    return jcfg, cfg, jparams, params


@pytest.fixture(scope="module")
def dense():
    return _model(moe=False)


@pytest.fixture(scope="module")
def moe():
    return _model(moe=True)


def _batches(vocab):
    spec = EV.EvalSpec(**vars(SPEC))
    return EV.synthetic_eval_batches(vocab, spec)


def test_stage_registry_matches_jax():
    assert "evaluate" in STAGES.names()
    assert STAGES.names() == JAX_STAGES.names()


def test_cross_entropy_matches_jax():
    """Padded vocab columns are masked; the mean is over every token."""
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((2, 5, 48))).astype(np.float32)
    labels = rng.integers(0, 40, (2, 5)).astype(np.int32)
    for vocab in (None, 40, 48):
        got = float(T.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels), vocab))
        want = float(jax_T.cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels), vocab))
        assert got == pytest.approx(want, rel=PPL_RTOL)


def test_eval_batches_token_for_token_equal_jax():
    b = _batches(256)
    jb = jax_EV.synthetic_eval_batches(256, SPEC)
    assert set(b) == set(jb) == {"ppl", "acc", "shifted"}
    for split in b:
        assert len(b[split]) == len(jb[split]) == 2
        for (t, l), (jt, jl) in zip(b[split], jb[split]):
            np.testing.assert_array_equal(t, jt)
            np.testing.assert_array_equal(l, jl)
    # the shifted split draws other start tokens from the same chains
    assert not np.array_equal(b["shifted"][0][0][:, 0], b["acc"][0][0][:, 0])
    recipe = PruneRecipe.load(RECIPE)
    d = EV.default_eval_batches(config_from_dict(jax_config_to_dict(
        small_config())), recipe)
    jd = jax_EV.default_eval_batches(small_config(), JaxRecipe.load(RECIPE))
    for split in d:
        for (t, _), (jt, _) in zip(d[split], jd[split]):
            assert t.shape == (recipe.calibration.batch_size,
                               recipe.calibration.seq_len)
            np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_perplexity_matches_jax(request, arch):
    jcfg, cfg, jparams, params = request.getfixturevalue(arch)
    b = _batches(cfg.vocab)
    ppl = EV.perplexity(params, cfg, b["ppl"])
    jppl = jax_EV.perplexity(jparams, jcfg, b["ppl"])
    assert ppl == pytest.approx(jppl, rel=PPL_RTOL)


def _near_ties(logits: np.ndarray, labels: np.ndarray, k: int) -> int:
    """Tokens whose label logit lies within TIE_ATOL of the k-th largest."""
    kth = -np.sort(-logits, axis=-1)[..., k - 1]
    gold = np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    return int((np.abs(gold - kth) <= TIE_ATOL).sum())


@pytest.mark.parametrize("arch", ["dense", "moe"])
def test_topk_accuracy_matches_jax(request, arch):
    jcfg, cfg, jparams, params = request.getfixturevalue(arch)
    b = _batches(cfg.vocab)
    slack = {}
    for split in ("acc", "shifted"):
        top1, top5 = EV.topk_accuracy(params, cfg, b[split])
        jtop1, jtop5 = jax_EV.topk_accuracy(jparams, jcfg, b[split])
        jlogits = [np.asarray(jax_T.forward(jparams, jcfg, t,
                                            compute_dtype=jnp.float32)[0])[
                       ..., :cfg.vocab] for t, _ in b[split]]
        # batches are equal-sized: the mean of batch means is the token
        # mean, so each near tie may move it by 100 / n tokens
        n_tok = sum(lab.size for _, lab in b[split])
        for k, got, want in ((1, top1, jtop1), (5, top5, jtop5)):
            ties = sum(_near_ties(lg, np.asarray(lab), k)
                       for lg, (_, lab) in zip(jlogits, b[split]))
            slack[(split, k)] = 100.0 * ties / n_tok
            assert abs(got - want) <= slack[(split, k)] + 1e-9, (
                split, k, got, want, ties)
    acc = EV.accuracy(params, cfg, b["acc"], b["shifted"])
    jacc = jax_EV.accuracy(jparams, jcfg, b["acc"], b["shifted"])
    bound = (slack[("acc", 1)] + slack[("acc", 5)]
             + slack[("shifted", 1)]) / 3
    assert 0.0 <= acc <= 100.0 and abs(acc - jacc) <= bound + 1e-9


def test_topk_counts_a_tied_label_once(dense, monkeypatch):
    """All-equal logits: every index ties for the top k; a label is
    counted once (a hit rate of at most 100%), never once per tie."""
    _, cfg, _, params = dense

    def flat(params, cfg, tokens):
        return torch.zeros((*np.shape(tokens), cfg.vocab + 8))

    monkeypatch.setattr(EV, "_logits", flat)
    b = _batches(cfg.vocab)
    top1, top5 = EV.topk_accuracy(params, cfg, b["acc"], k=5)
    assert 0.0 <= top1 <= top5 <= 100.0


@pytest.mark.parametrize("order", [EVAL_STAGES,
                                   ("rank", "plan", "prune", "report",
                                    "evaluate")])
def test_evaluate_stage_puts_quality_in_both_reports(dense, order):
    """A recipe built here lists 'evaluate'; both packages report ppl and
    acc, each the package's own evaluate_quality of the pruned params,
    and the two agree to the tolerance the pruned params allow."""
    jcfg, cfg, jparams, params = dense
    recipe = PruneRecipe.load(RECIPE).replace(stages=order)
    jrecipe = JaxRecipe.load(RECIPE).replace(stages=order)
    assert recipe.to_dict() == jrecipe.to_dict()
    art = MosaicPipeline(recipe).run(params, cfg)
    jart = JaxPipeline(jrecipe).run(jparams, jcfg)
    b = EV.default_eval_batches(art.cfg, recipe)
    want = EV.evaluate_quality(art.params, art.cfg, b)
    for rep in (art.report, jart.report):
        assert {"ppl", "acc", "bytes_after"} <= set(rep)
        assert rep["ppl"] > 1.0 and 0.0 <= rep["acc"] <= 100.0
    assert art.report["ppl"] == want["ppl"]
    assert art.report["acc"] == want["acc"]
    assert art.report["ppl"] == pytest.approx(jart.report["ppl"], rel=1e-3)


def test_evaluate_stage_takes_supplied_batches(dense):
    _, cfg, _, params = dense
    recipe = PruneRecipe.load(RECIPE).replace(stages=EVAL_STAGES)
    b = _batches(cfg.vocab)
    art = MosaicPipeline(recipe).run(params, cfg, eval_batches=b)
    assert art.report["ppl"] == EV.perplexity(art.params, art.cfg, b["ppl"])


@pytest.mark.parametrize("preset", ["cloud", "edge", "mobile"])
def test_platform_presets_resolve_as_in_jax(dense, preset):
    """recipes/<preset>.json (category null): the same category through
    select_category at every model size, and the same targets."""
    jcfg, cfg, jparams, params = dense
    path = os.path.join(REPO, "recipes", f"{preset}.json")
    recipe, jrecipe = PruneRecipe.load(path), JaxRecipe.load(path)
    assert recipe.category is None and recipe.to_dict() == jrecipe.to_dict()
    for dense_bytes in (1 << 20, 3 << 30, 6 << 30, 16 << 30, 100 << 30):
        assert (PC.resolve_category(recipe, dense_bytes)
                == jax_PC.resolve_category(jrecipe, dense_bytes))
        plat = PC.PLATFORMS[recipe.platform]
        jplat = jax_PC.PLATFORMS[jrecipe.platform]
        assert (PC.select_category(plat, dense_bytes, recipe.p,
                                   recipe.structured_share)
                == jax_PC.select_category(jplat, dense_bytes, jrecipe.p,
                                          jrecipe.structured_share))
    rng = np.random.default_rng(7)
    rank = {(i, n): float(rng.random()) for i in range(4)
            for n in ("q", "k", "v", "o", "gate", "up", "down")}
    weights = {k: int(rng.integers(100, 10_000)) for k in rank}
    targets = PL.plan_from_recipe(rank, recipe, weights=weights)
    jtargets = jax_PL.plan_from_recipe(rank, jrecipe, weights=weights)
    assert set(targets) == set(jtargets)
    for k, v in jtargets.items():
        assert targets[k] == pytest.approx(float(v), rel=1e-6)
