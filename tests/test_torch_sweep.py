"""The port's sweep subsystem and whole-expert removal, at small size on
the CPU (f32).

Ports of the JAX package's sweep tests (``tests/test_sweep.py``: grid
codec, labels, profile once / prune many, the quant axis, a saved
profile reused, lazy Hessians, a one-point sweep token-identical to a
direct run on both serve paths, resume and its invalidation, Pareto),
run on the port with the JAX params (through numpy). Against the JAX
package: grid JSON and labels equal; on the same rows the Pareto CSV and
markdown text equal; a sweep directory written by either package resumes
in the other with no point re-pruned, and the two ``pareto.csv`` files
then agree outside the two seconds columns. Whole-expert removal keeps
JAX's experts (router and expert tensors equal) and its bundle
cross-loads both ways.
"""
import csv
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import repro.core.sweep as jax_sweep
from repro.core import structured as jax_S
from repro.core.artifact import PrunedArtifact as JaxArtifact
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.recipe import CalibrationSpec as JaxCalibrationSpec
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.models import transformer as jax_T
from repro.models.specs import MoESpec as JaxMoESpec
from repro.models.specs import config_from_dict as jax_config_from_dict
from repro.models.specs import config_to_dict as jax_config_to_dict
from tests.conftest import small_config

import repro_torch.core.sweep as sweep_mod
from repro_torch.common.interop import params_from_numpy
from repro_torch.common.tree import iter_paths
from repro_torch.core import structured as S
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import RankArtifact, profile_model
from repro_torch.core.recipe import CalibrationSpec, PruneRecipe
from repro_torch.core.sweep import (CSV_COLUMNS, GridSpec, annotate_pareto,
                                    pareto_csv, pareto_markdown, point_label,
                                    run_sweep)
from repro_torch.models import transformer as T
from repro_torch.models.specs import MoESpec, config_from_dict, config_to_dict
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine
from repro_torch.serve.sparse import pack_model

CPU = torch.device("cpu")
SECONDS = ("prune_seconds", "point_seconds")


def _calib(vocab, n=2, batch=2, seq=16):
    return [np.random.default_rng(100 + i).integers(
        0, vocab, (batch, seq)).astype(np.int32) for i in range(n)]


@pytest.fixture(scope="module")
def model():
    jcfg = small_config()           # d_model=64, d_ff=128: tileable @16
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    return cfg, params, jcfg, jparams


def _recipe_kw(kw):
    kw.setdefault("p", 0.5)
    kw.setdefault("category", "composite")
    kw.setdefault("selector", "wanda_block")
    kw.setdefault("align_channels", 16)
    kw.setdefault("block", 16)
    return kw


def base_recipe(cfg, **kw):
    kw = _recipe_kw(kw)
    kw.setdefault("calibration", CalibrationSpec(4, 2, 16))
    return PruneRecipe(arch=cfg.name, **kw)


def jax_base_recipe(cfg, **kw):
    kw = _recipe_kw(kw)
    kw.setdefault("calibration", JaxCalibrationSpec(4, 2, 16))
    return JaxRecipe(arch=cfg.name, **kw)


# ------------------------------------------------------------- grid spec

def test_grid_points_and_json_roundtrip():
    g = GridSpec(p=(0.3, 0.5), category=("composite", "unstructured"))
    base = PruneRecipe(arch="x", p=0.9, selector="wanda")
    pts = g.points(base)
    assert len(pts) == 4 == g.n_points()
    assert {r.p for r in pts} == {0.3, 0.5}
    assert {r.category for r in pts} == {"composite", "unstructured"}
    assert all(r.selector == "wanda" for r in pts)   # inherited from base
    assert GridSpec.from_json(g.to_json()) == g
    with pytest.raises(ValueError):
        GridSpec.from_dict({"alpha": [1.0]})
    with pytest.raises(ValueError):          # scalar, not a list of values
        GridSpec.from_dict({"category": "composite"})
    with pytest.raises(ValueError):
        GridSpec.from_dict({"p": 0.5})
    # the JAX package reads and writes the same JSON, quant axis included
    gq = GridSpec(p=(0.3, 0.5), quant=("none", "int8"))
    jg = jax_sweep.GridSpec.from_json(gq.to_json())
    assert jg.to_json() == gq.to_json()
    jpts = jg.points(JaxRecipe(arch="x", p=0.9, selector="wanda"))
    assert [r.to_dict() for r in gq.points(base)] == [
        r.to_dict() for r in jpts]


def test_point_labels_unique_axes():
    r = PruneRecipe(arch="x", p=0.5, category=None, granularity="layer")
    assert point_label(r) == "p0.5-auto-wanda-layer"
    for kw in ({"p": 0.5, "granularity": "layer", "category": None},
               {"p": 0.5, "quant": "int8", "selector": "sparsegpt"},
               {"p": 0.25, "category": "structured"}):
        assert point_label(PruneRecipe(arch="x", **kw)) == \
            jax_sweep.point_label(JaxRecipe(arch="x", **kw))


# ------------------------------------------- profile-once / prune-many

def test_sweep_profiles_once_and_reports(model, tmp_path, monkeypatch):
    cfg, params, _, _ = model
    calls = []
    real = sweep_mod.profile_model

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(sweep_mod, "profile_model", counting)
    out = str(tmp_path / "sweep")
    grid = GridSpec(p=(0.4, 0.6), category=("composite", "unstructured"))
    res = run_sweep(base_recipe(cfg), grid, params, cfg, out_dir=out,
                    calibration=_calib(cfg.vocab))
    assert len(calls) == 1                      # E5: one profile, N points
    assert res.profiled
    assert len(res.rows) == 4
    for row in res.rows:
        assert row["ppl"] > 0
        assert 0.0 <= row["acc"] <= 100.0
        assert row["bytes_after"] > 0
        assert row["prune_seconds"] is not None
        assert PrunedArtifact.is_artifact(row["artifact_dir"])
    assert RankArtifact.is_artifact(os.path.join(out, "profile"))
    assert any(r["pareto"] for r in res.rows)
    with open(res.csv_path) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 4
    for needed in ("ppl", "acc", "bytes_after", "prune_seconds",
                   "quality_per_byte", "pareto"):
        assert all(r[needed] != "" for r in rows), needed
    assert os.path.exists(res.md_path)


def test_sweep_quant_axis(model, tmp_path):
    """The quant grid axis: points fan out over precision, every row
    carries a quant column, and int8 points report real (smaller)
    bytes_after than their unquantized twin."""
    cfg, params, _, _ = model
    out = str(tmp_path / "sweep-quant")
    grid = GridSpec(quant=("none", "int8"))
    base = base_recipe(cfg, category="unstructured")
    assert {r.quant for r in grid.points(base)} == {"none", "int8"}
    labels = [point_label(r) for r in grid.points(base)]
    assert len(set(labels)) == 2                # int8 visible in the label
    res = run_sweep(base, grid, params, cfg, out_dir=out,
                    calibration=_calib(cfg.vocab))
    by_quant = {r["quant"]: r for r in res.rows}
    assert set(by_quant) == {"none", "int8"}
    assert by_quant["int8"]["bytes_after"] < by_quant["none"]["bytes_after"]
    with open(res.csv_path) as f:
        rows = list(csv.DictReader(f))
    assert {r["quant"] for r in rows} == {"none", "int8"}


def test_sweep_reuses_saved_profile_without_profiling(model, tmp_path,
                                                      monkeypatch):
    cfg, params, _, _ = model
    ra = profile_model(params, cfg, _calib(cfg.vocab))
    d = str(tmp_path / "profile")
    ra.save(d)
    monkeypatch.setattr(sweep_mod, "profile_model",
                        lambda *a, **k: pytest.fail("re-profiled!"))
    res = run_sweep(base_recipe(cfg), GridSpec(p=(0.3, 0.6)), params, cfg,
                    rank_artifact=RankArtifact.load(d, CPU),
                    calibration=_calib(cfg.vocab))
    assert not res.profiled
    assert len(res.rows) == 2


def test_sweep_lazy_hessians_for_sparsegpt_points(model, monkeypatch):
    """A Hessian-free saved profile gains Hessians lazily (one hessian
    pass), not via a full re-profile."""
    cfg, params, _, _ = model
    ra = profile_model(params, cfg, _calib(cfg.vocab))
    assert ra.hessians is None
    monkeypatch.setattr(sweep_mod, "profile_model",
                        lambda *a, **k: pytest.fail("re-profiled!"))
    grid = GridSpec(selector=("wanda", "sparsegpt"))
    res = run_sweep(base_recipe(cfg, category="unstructured",
                                stages=("rank", "plan", "prune", "report")),
                    grid, params, cfg, rank_artifact=ra,
                    calibration=_calib(cfg.vocab))
    assert res.rank_artifact.hessians is not None
    assert ra.hessians is None                  # input not mutated
    assert len(res.rows) == 2


def test_one_point_sweep_token_identical_to_direct_run(model, tmp_path):
    """Regression: sweeping a single point == running the pipeline
    directly, down to generated tokens on dense AND sparse serve paths."""
    cfg, params, _, _ = model
    calib = _calib(cfg.vocab)
    recipe = base_recipe(cfg)
    direct = MosaicPipeline(recipe).run(params, cfg, calibration=calib)
    res = run_sweep(recipe, GridSpec(), params, cfg,
                    out_dir=str(tmp_path / "one"), calibration=calib)
    assert len(res.rows) == 1
    loaded = PrunedArtifact.load(res.rows[0]["artifact_dir"], CPU)
    for (p1, l1), (p2, l2) in zip(iter_paths(direct.params),
                                  iter_paths(loaded.params)):
        assert p1 == p2
        assert torch.equal(l1, l2)
    prompt = np.random.default_rng(5).integers(0, cfg.vocab, (2, 8))
    serve = ServeConfig(max_seq=16, compute_dtype=torch.float32,
                        cache_dtype=torch.float32)

    def gen(art, sparse):
        return Engine.from_artifact(art, serve, sparse=sparse).generate(
            prompt, 6)

    assert torch.equal(gen(direct, False), gen(loaded, False))
    assert loaded.packed and torch.equal(gen(direct, True),
                                         gen(loaded, True))


def test_sweep_resume_skips_existing_points(model, tmp_path, monkeypatch):
    """Re-running a sweep over the same out_dir re-executes nothing:
    rows come back from the saved report.json bundles. resume=False
    forces re-execution."""
    cfg, params, _, _ = model
    out = str(tmp_path / "sweep")
    grid = GridSpec(p=(0.4, 0.6))
    first = run_sweep(base_recipe(cfg), grid, params, cfg, out_dir=out,
                      calibration=_calib(cfg.vocab))
    ran = []
    orig_run = MosaicPipeline.run

    def counting_run(self, *a, **k):
        ran.append(1)
        return orig_run(self, *a, **k)

    monkeypatch.setattr(MosaicPipeline, "run", counting_run)
    # a fully-resumed re-run must not even profile
    monkeypatch.setattr(sweep_mod, "profile_model",
                        lambda *a, **k: pytest.fail("re-profiled!"))
    msgs = []
    second = run_sweep(base_recipe(cfg), grid, params, cfg, out_dir=out,
                       calibration=_calib(cfg.vocab), progress=msgs.append)
    assert not ran                             # every point was resumed
    assert not second.profiled and second.rank_artifact is None
    assert any("resume: skipped 2/2" in m for m in msgs)
    by_label = {r["label"]: r for r in first.rows}
    for row in second.rows:
        ref = by_label[row["label"]]
        assert row["ppl"] == pytest.approx(ref["ppl"])
        assert row["bytes_after"] == ref["bytes_after"]
        assert row["point_seconds"] == 0.0
    third = run_sweep(base_recipe(cfg), grid, params, cfg, out_dir=out,
                      rank_artifact=first.rank_artifact,
                      calibration=_calib(cfg.vocab), resume=False)
    assert len(ran) == 2
    assert all(r["point_seconds"] > 0 for r in third.rows)


def test_sweep_resume_invalidates_on_recipe_change(model, tmp_path):
    """A bundle only resumes when its saved recipe.json equals the
    current point recipe: the label doesn't encode fields like spread,
    so editing the base recipe must re-execute, not serve stale rows."""
    cfg, params, _, _ = model
    out = str(tmp_path / "sweep")
    grid = GridSpec(p=(0.5,))
    first = run_sweep(base_recipe(cfg), grid, params, cfg, out_dir=out,
                      calibration=_calib(cfg.vocab))
    changed = run_sweep(base_recipe(cfg, spread=0.1), grid, params, cfg,
                        out_dir=out, rank_artifact=first.rank_artifact,
                        calibration=_calib(cfg.vocab))
    assert changed.rows[0]["point_seconds"] > 0      # re-executed
    again = run_sweep(base_recipe(cfg, spread=0.1), grid, params, cfg,
                      out_dir=out, rank_artifact=first.rank_artifact,
                      calibration=_calib(cfg.vocab))
    assert again.rows[0]["point_seconds"] == 0.0
    # a truncated report.json (killed mid-save) re-executes, not crashes
    with open(os.path.join(again.rows[0]["artifact_dir"],
                           "report.json"), "w") as f:
        f.write('{"ppl": 1.2, "by')
    healed = run_sweep(base_recipe(cfg, spread=0.1), grid, params, cfg,
                       out_dir=out, rank_artifact=first.rank_artifact,
                       calibration=_calib(cfg.vocab))
    assert healed.rows[0]["point_seconds"] > 0
    assert healed.rows[0]["ppl"] is not None


# ---------------------------------------------------------- pareto logic

def _rows():
    return [
        {"ppl": 10.0, "acc": 50.0, "bytes_after": 1000},   # dominated
        {"ppl": 8.0, "acc": 55.0, "bytes_after": 900},     # dominates ^
        {"ppl": 20.0, "acc": 40.0, "bytes_after": 500},    # smallest
        {"ppl": 7.0, "acc": 60.0, "bytes_after": 2000},    # best quality
    ]


def test_annotate_pareto_front():
    rows = annotate_pareto(_rows())
    assert [r["pareto"] for r in rows] == [False, True, True, True]
    assert rows[0]["quality_per_byte"] == pytest.approx(
        50.0 / (1000 / 2 ** 20))
    text = pareto_csv(rows[:1])
    assert text.splitlines()[0].startswith("label,arch,p,")


def test_annotate_pareto_handles_missing_quality():
    rows = [{"ppl": None, "acc": None, "bytes_after": 100},
            {"ppl": 5.0, "acc": 10.0, "bytes_after": 100}]
    annotate_pareto(rows)
    assert rows[0]["pareto"] is False and rows[0]["quality_per_byte"] is None
    assert rows[1]["pareto"] is True


def test_pareto_text_equals_jax_on_same_rows():
    rows = _rows() + [{"ppl": None, "acc": None, "bytes_after": 100}]
    for i, r in enumerate(rows):
        r.update(label=f"p{i}", arch="x", p=0.5, category="composite",
                 selector="wanda", granularity="projection", quant="none",
                 params_after=7, prune_seconds=0.123456,
                 point_seconds=1.5 * i, flop_savings=0.25 * i,
                 expert_plans=0)
    jrows = [dict(r) for r in rows]
    annotate_pareto(rows)
    jax_sweep.annotate_pareto(jrows)
    assert rows == jrows
    assert pareto_csv(rows) == jax_sweep.pareto_csv(jrows)
    assert pareto_markdown(rows) == jax_sweep.pareto_markdown(jrows)
    assert CSV_COLUMNS == jax_sweep.CSV_COLUMNS
    assert sweep_mod.GRID_AXES == jax_sweep.GRID_AXES


def _csv_without_seconds(path: str) -> list:
    with open(path) as f:
        return [{k: v for k, v in r.items() if k not in SECONDS}
                for r in csv.DictReader(io.StringIO(f.read()))]


def test_sweep_dirs_resume_across_packages(model, tmp_path, monkeypatch):
    """A sweep directory written by either package resumes in the other
    with no point re-pruned and no profile taken; the resumed Pareto CSV
    equals the writer's outside the two seconds columns."""
    cfg, params, jcfg, jparams = model
    grid = {"p": [0.4, 0.6], "category": ["composite", "unstructured"]}
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jres = jax_sweep.run_sweep(jax_base_recipe(jcfg),
                               jax_sweep.GridSpec.from_dict(grid), jparams,
                               jcfg, out_dir=jax_dir,
                               calibration=_calib(cfg.vocab))
    res = run_sweep(base_recipe(cfg), GridSpec.from_dict(grid), params, cfg,
                    out_dir=port_dir, calibration=_calib(cfg.vocab))
    for mod, pipe in ((sweep_mod, MosaicPipeline),
                      (jax_sweep, JaxPipeline)):
        monkeypatch.setattr(mod, "profile_model",
                            lambda *a, **k: pytest.fail("re-profiled!"))
        monkeypatch.setattr(pipe, "run",
                            lambda *a, **k: pytest.fail("re-pruned!"))
    in_port = run_sweep(base_recipe(cfg), GridSpec.from_dict(grid), params,
                        cfg, out_dir=jax_dir, calibration=_calib(cfg.vocab))
    assert _csv_without_seconds(in_port.csv_path) == \
        _csv_without_seconds(os.path.join(jax_dir, "pareto.csv")) != []
    assert [r["label"] for r in in_port.rows] == [
        r["label"] for r in jres.rows]
    with open(res.csv_path) as f:
        port_csv = f.read()
    in_jax = jax_sweep.run_sweep(jax_base_recipe(jcfg),
                                 jax_sweep.GridSpec.from_dict(grid),
                                 jparams, jcfg, out_dir=port_dir,
                                 calibration=_calib(cfg.vocab))
    assert all(r["point_seconds"] == 0.0 for r in in_jax.rows)
    with open(os.path.join(str(tmp_path), "port.csv"), "w") as f:
        f.write(port_csv)
    assert _csv_without_seconds(in_jax.csv_path) == \
        _csv_without_seconds(os.path.join(str(tmp_path), "port.csv"))


# ------------------------------------------------ whole-expert removal

@pytest.fixture(scope="module")
def hybrid():
    jcfg = small_config(moe=True, mamba=True)
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    return cfg, params, jcfg, jparams


def test_expert_pruning_beyond_paper(hybrid):
    """Whole-expert removal: router and expert tensors shrink
    consistently, keep JAX's experts exactly, and the forward stays
    NaN-free."""
    cfg, params, jcfg, jparams = hybrid
    new_p, new_cfg = S.prune_structured(params, cfg, {}, expert_frac=0.5)
    jnew_p, jnew_cfg = jax_S.prune_structured(jparams, jcfg, {},
                                              expert_frac=0.5)
    assert config_to_dict(new_cfg) == jax_config_to_dict(jnew_cfg)
    n_moe = 0
    for i, spec in enumerate(new_cfg.layers()):
        if isinstance(spec.ffn, MoESpec):
            n_moe += 1
            blk = new_p["blocks"][i]["moe"]
            assert spec.ffn.n_experts == 2            # 4 -> 2 at frac 0.5
            assert blk["router"].shape[1] == 2
            assert blk["up"].shape[0] == 2
            assert spec.ffn.n_experts >= spec.ffn.top_k
            assert isinstance(jnew_cfg.layer(i).ffn, JaxMoESpec)
            for name, t in blk.items():
                np.testing.assert_array_equal(
                    t.numpy(), np.asarray(jnew_p["blocks"][i]["moe"][name]))
    assert n_moe == 2
    toks = torch.from_numpy(_calib(cfg.vocab)[0]).long()
    lo, _, _ = T.forward(new_p, new_cfg, toks, compute_dtype=torch.float32)
    assert not bool(torch.isnan(lo).any())
    jlo, _, _ = jax_T.forward(jnew_p, jnew_cfg, toks.numpy(),
                              compute_dtype=jnp.float32)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jlo), rtol=1e-4,
                               atol=1e-4)


def test_expert_frac_keeps_top_k_and_ranks_by_router_and_weight_mass(
        hybrid):
    cfg, params, _, _ = hybrid
    new_p, new_cfg = S.prune_structured(params, cfg, {}, expert_frac=0.9)
    layer = next(i for i, s in enumerate(cfg.layers())
                 if isinstance(s.ffn, MoESpec))
    assert new_cfg.layer(layer).ffn.n_experts == cfg.layer(layer).ffn.top_k
    moe = params["blocks"][layer]["moe"]
    score = (moe["router"].abs().sum(0) * (
        moe["up"].abs().sum((1, 2)) + moe["down"].abs().sum((1, 2))
        + moe["gate"].abs().sum((1, 2)))).numpy()
    best = np.sort(np.argsort(-score)[:2])
    assert torch.equal(new_p["blocks"][layer]["moe"]["up"],
                       moe["up"][torch.from_numpy(best)])


def test_expert_removed_bundle_cross_loads_both_ways(hybrid, tmp_path):
    """A bundle with removed experts (plans packed over the smaller
    expert stacks) saved by the port loads in JAX, and JAX's in the
    port, with equal params, config and plan keys."""
    cfg, params, jcfg, jparams = hybrid
    new_p, new_cfg = S.prune_structured(params, cfg, {}, expert_frac=0.5)
    recipe = PruneRecipe(arch=cfg.name, p=0.5, block=16)
    art = PrunedArtifact(params=new_p, cfg=new_cfg, recipe=recipe,
                         targets={}, packed=pack_model(new_p, new_cfg,
                                                       block=16),
                         report={"category": "structured"})
    art.save(str(tmp_path / "port"))
    jart = JaxArtifact.load(str(tmp_path / "port"))
    assert jax_config_to_dict(jart.cfg) == config_to_dict(new_cfg)
    in_jax = params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jart.params), CPU)
    for (pa, a), (pb, b) in zip(iter_paths(in_jax), iter_paths(new_p)):
        assert pa == pb and torch.equal(a, b)
    assert set(jart.packed) == set(art.packed) != set()
    jnew_p, jnew_cfg = jax_S.prune_structured(jparams, jcfg, {},
                                              expert_frac=0.5)
    JaxArtifact(params=jnew_p, cfg=jnew_cfg,
                recipe=JaxRecipe.from_dict(recipe.to_dict()), targets={},
                packed={}, report={"category": "structured"}).save(
                    str(tmp_path / "jax"))
    loaded = PrunedArtifact.load(str(tmp_path / "jax"), CPU)
    assert config_to_dict(loaded.cfg) == jax_config_to_dict(jnew_cfg)
    for (pa, a), (pb, b) in zip(iter_paths(loaded.params),
                                iter_paths(new_p)):
        assert pa == pb and torch.equal(a, b)
    assert jax_config_from_dict(config_to_dict(loaded.cfg)) == jnew_cfg
