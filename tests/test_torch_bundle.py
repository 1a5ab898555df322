"""Bundle I/O across the two packages.

A checkpoint or a ``PrunedArtifact`` bundle saved by either package loads
in the other: the same ``step_*/arrays.npz`` key paths, the same JSON
documents, the same plan arrays. Each package prunes the same small
model (JAX ``init_model`` params, through numpy) with the golden-smoke
recipe and saves its bundle; the other package loads it with params,
config, targets and plans equal, and its static engine emits the same
greedy tokens, dense and through the block-sparse path. A bf16 leaf,
which the JAX package writes as raw ``'<V2'`` records, reads back as the
same bf16 bits.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint.manager import CheckpointManager as JaxCkpt
from repro.core.artifact import PrunedArtifact as JaxArtifact
from repro.core.pipeline import MosaicPipeline as JaxPipeline
from repro.core.rank_controller import RankArtifact as JaxRankArtifact
from repro.core.recipe import PruneRecipe as JaxRecipe
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.engine import Engine as JaxEngine
from tests.conftest import small_config

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.common.tree import iter_paths
from repro_torch.core.artifact import PrunedArtifact
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import RankArtifact
from repro_torch.core.recipe import PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.launch import prune as prune_launcher
from repro_torch.models.specs import config_to_dict
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")
CPU = torch.device("cpu")
S0, N_NEW = 10, 8


def _leaves_np(tree):
    return {p: np.asarray(v) for p, v in iter_paths(tree)}


def _assert_params_equal(port_params, jax_params):
    got = _leaves_np(params_to_numpy(port_params))
    want = _leaves_np(jax.tree_util.tree_map(np.asarray, jax_params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))


def _assert_plans_equal(packed, jpacked):
    assert set(packed) == set(jpacked) and packed
    for key, p in packed.items():
        jp = jpacked[key]
        assert (p.block, p.density) == (jp.block, jp.density)
        np.testing.assert_array_equal(p.counts.numpy(), np.asarray(jp.counts))
        np.testing.assert_array_equal(p.indices.numpy(),
                                      np.asarray(jp.indices))


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{"jax": dir, "port": dir}: the golden-smoke bundle each package
    saved from the same initial params."""
    jcfg = small_config()
    jparams = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    jdir = str(tmp_path_factory.mktemp("bundle-jax"))
    JaxPipeline(JaxRecipe.load(RECIPE)).run(jparams, jcfg).save(jdir)
    from repro_torch.models.specs import config_from_dict
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               CPU)
    pdir = str(tmp_path_factory.mktemp("bundle-port"))
    MosaicPipeline(PruneRecipe.load(RECIPE)).run(params, cfg).save(pdir)
    return {"jax": jdir, "port": pdir}


def test_checkpoint_round_trip_with_bf16_leaf(tmp_path):
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 5)).astype(np.float32)
    idx = rng.integers(0, 9, (4,)).astype(np.int32)
    half = jnp.asarray(rng.standard_normal((2, 6)), jnp.bfloat16)
    jtree = {"blocks": [{"w": jnp.asarray(w), "h": half}],
             "idx": jnp.asarray(idx)}
    JaxCkpt(str(tmp_path / "j"), keep=1).save(3, jtree, extra_meta={"a": 1})
    raw = np.load(tmp_path / "j" / "step_00000003" / "arrays.npz")
    assert raw["blocks/0/h"].dtype.str == "|V2"       # the '<V2' records
    like = {"blocks": [{"w": torch.empty(3, 5), "h": torch.empty(
        2, 6, dtype=torch.bfloat16)}], "idx": torch.empty(4, dtype=torch.int32)}
    mgr = CheckpointManager(str(tmp_path / "j"), keep=1)
    got = mgr.restore(like, device=CPU)
    assert mgr.latest_step() == 3 and mgr.meta()["a"] == 1
    np.testing.assert_array_equal(got["blocks"][0]["w"].numpy(), w)
    np.testing.assert_array_equal(got["idx"].numpy(), idx)
    h = got["blocks"][0]["h"]
    assert h.dtype == torch.bfloat16
    np.testing.assert_array_equal(h.float().numpy(),
                                  np.asarray(half, np.float32))
    # the port writes the same keys, and bf16 as the same 2-byte records
    tree = {"blocks": [{"w": torch.from_numpy(w), "h": h}],
            "idx": torch.from_numpy(idx)}
    CheckpointManager(str(tmp_path / "p"), keep=1).save(3, tree)
    mine = np.load(tmp_path / "p" / "step_00000003" / "arrays.npz")
    assert sorted(mine.files) == sorted(raw.files)
    for key in raw.files:
        assert mine[key].dtype.str == raw[key].dtype.str
        assert mine[key].tobytes() == raw[key].tobytes()
    back = CheckpointManager(str(tmp_path / "p")).restore(like, device=CPU)
    assert torch.equal(back["blocks"][0]["h"], h)
    with pytest.raises(ValueError, match="stored shape"):
        mgr.restore({"idx": torch.empty(5, dtype=torch.int32)}, device=CPU)


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_bundle_loads_in_both_packages_equal(bundles, saved_by):
    d = bundles[saved_by]
    art = PrunedArtifact.load(d, device="cpu")
    jart = JaxArtifact.load(d)
    assert PrunedArtifact.is_artifact(d) and not PrunedArtifact.is_artifact(
        os.path.join(d, "step_00000000"))
    assert json.dumps(config_to_dict(art.cfg), sort_keys=True) == \
        json.dumps(jax_config_to_dict(jart.cfg), sort_keys=True)
    assert art.cfg.layer(0).mixer.n_q < 4, "heads were pruned"
    assert art.recipe.to_dict() == jart.recipe.to_dict()
    assert art.targets == jart.targets and art.targets
    assert art.report == jart.report
    _assert_params_equal(art.params, jart.params)
    _assert_plans_equal(art.packed, jart.packed)
    assert all(p.counts.device == CPU for p in art.packed.values())


def test_port_bundle_round_trips_in_memory(bundles, tmp_path):
    art = PrunedArtifact.load(bundles["port"], device="cpu")
    art.save(str(tmp_path))
    again = PrunedArtifact.load(str(tmp_path), device="cpu")
    for (pa, a), (pb, b) in zip(iter_paths(art.params),
                                iter_paths(again.params)):
        assert pa == pb and torch.equal(a, b)
    assert again.targets == art.targets and again.cfg == art.cfg
    for key, p in art.packed.items():
        assert torch.equal(p.counts, again.packed[key].counts)
        assert torch.equal(p.indices, again.packed[key].indices)
    with pytest.raises(FileNotFoundError):
        PrunedArtifact.load(str(tmp_path / "missing"), device="cpu")


@pytest.mark.parametrize("saved_by", ["jax", "port"])
def test_bundle_serves_equal_greedy_tokens(bundles, saved_by):
    d = bundles[saved_by]
    art = PrunedArtifact.load(d, device="cpu")
    jart = JaxArtifact.load(d)
    prompt = SyntheticCorpus(art.cfg.vocab, seed=0).batch(0, 3, S0)[:, :S0]
    jserve = JaxServeConfig(max_seq=S0 + N_NEW, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
    serve = ServeConfig(max_seq=S0 + N_NEW, compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    for sparse in (False, True):
        want = np.asarray(JaxEngine.from_artifact(jart, jserve, sparse=sparse)
                          .generate(jnp.asarray(prompt), N_NEW))
        got = Engine.from_artifact(art, serve, sparse=sparse).generate(
            prompt, N_NEW)
        np.testing.assert_array_equal(got.numpy(), want)


def test_rank_artifact_round_trips_across_packages(bundles, tmp_path):
    rng = np.random.default_rng(1)
    rank = {(0, "q"): 1.25, (1, "up"): 0.75}
    anorms = {(0, "attn_qkv"): rng.random(8).astype(np.float32),
              (1, "mlp_in"): rng.random(8).astype(np.float32)}
    weights = {(0, "q"): 64, (1, "up"): 128}
    JaxRankArtifact(rank=rank, anorms={k: jnp.asarray(v)
                                       for k, v in anorms.items()},
                    weights=weights, n_tokens=96,
                    profile_seconds=0.5).save(str(tmp_path / "j"))
    ra = RankArtifact.load(str(tmp_path / "j"), device="cpu")
    assert ra.rank == rank and ra.weights == weights
    assert ra.n_tokens == 96 and ra.hessians is None
    for k, v in anorms.items():
        np.testing.assert_array_equal(ra.anorms[k].numpy(), v)
    ra.save(str(tmp_path / "p"))
    back = JaxRankArtifact.load(str(tmp_path / "p"))
    assert back.rank == rank and back.weights == weights
    for k, v in anorms.items():
        np.testing.assert_array_equal(np.asarray(back.anorms[k]), v)


def test_prune_launcher_saves_a_bundle(tmp_path, capsys):
    out = str(tmp_path / "art")
    prune_launcher.main(["--smoke", "--recipe", RECIPE, "--out", out,
                         "--device", "cpu"])
    assert "saved PrunedArtifact" in capsys.readouterr().out
    art = JaxArtifact.load(out)
    assert art.packed and art.report["category"] == "composite"
