"""The port's static engine against the JAX engine, at f32.

The port prunes a small model with the golden-smoke recipe; the pruned
params go to the JAX package through numpy, with block plans that JAX's
``pack_model`` builds from them. Greedy tokens from the port's
``Engine.from_artifact``, dense and through the block-sparse path, equal
the JAX ``Engine``'s on the same prompts. The port's launcher runs the
same path end to end on the CPU.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.models import transformer as jax_T
from repro.models.specs import config_from_dict as jax_config_from_dict
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.serve.config import ServeConfig as JaxServeConfig
from repro.serve.engine import Engine as JaxEngine
from repro.serve.sparse import pack_model as jax_pack_model
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy, params_to_numpy
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.recipe import PruneRecipe
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.kernels import counters
from repro_torch.models.specs import config_from_dict, config_to_dict
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine, sample_token

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPE = os.path.join(REPO, "recipes", "golden-smoke.json")
CPU = torch.device("cpu")
S0, N_NEW = 10, 8


@pytest.fixture(scope="module")
def pruned():
    """(port artifact, JAX params, JAX config, JAX plans) of one model."""
    jcfg = small_config()
    cfg = config_from_dict(jax_config_to_dict(jcfg))
    jparams0 = jax.jit(jax_T.init_model, static_argnames="cfg")(
        jax.random.PRNGKey(0), cfg=jcfg)
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams0),
                               CPU)
    recipe = PruneRecipe.load(RECIPE)
    art = MosaicPipeline(recipe).run(params, cfg)
    jcfg_p = jax_config_from_dict(config_to_dict(art.cfg))
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(art.params))
    jpacked = jax_pack_model(jparams, jcfg_p, block=recipe.block)
    return art, jparams, jcfg_p, jpacked


def test_engine_greedy_tokens_equal_jax(pruned):
    art, jparams, jcfg, jpacked = pruned
    assert set(art.packed) == set(jpacked) and art.packed
    prompt = SyntheticCorpus(art.cfg.vocab, seed=0).batch(0, 3, S0)[:, :S0]
    jserve = JaxServeConfig(max_seq=S0 + N_NEW, compute_dtype=jnp.float32,
                            cache_dtype=jnp.float32)
    serve = ServeConfig(max_seq=S0 + N_NEW, compute_dtype=torch.float32,
                        cache_dtype=torch.float32)
    for sparse in (False, True):
        jeng = JaxEngine(jparams, jcfg, jserve,
                         packed=jpacked if sparse else None)
        want = np.asarray(jeng.generate(jnp.asarray(prompt), N_NEW))
        eng = Engine.from_artifact(art, serve, sparse=sparse)
        assert (eng.mlp_apply is not None) == sparse
        counters.reset()
        got, logits = eng.generate(prompt, N_NEW, return_logits=True)
        assert counters.snapshot() == {}, "CPU runs launch no kernel"
        np.testing.assert_array_equal(got.numpy(), want)
        assert logits.shape == (N_NEW, 3, art.cfg.padded_vocab)
        assert torch.equal(logits.argmax(-1).T, got[:, S0:])


def test_engine_stores_weights_in_compute_dtype(pruned):
    art = pruned[0]
    eng = Engine.from_artifact(art, ServeConfig(
        max_seq=32, compute_dtype=torch.bfloat16))
    w = eng.params["blocks"][0]["mlp"]["up"]
    assert w.dtype == torch.bfloat16
    assert art.params["blocks"][0]["mlp"]["up"].dtype == torch.float32
    prompt = SyntheticCorpus(art.cfg.vocab, seed=0).batch(0, 2, 8)[:, :8]
    out = eng.generate(prompt, 4)
    assert out.shape == (2, 12)
    with pytest.raises(ValueError, match="max_seq"):
        eng.generate(prompt, 40)


def test_sampled_generation_is_seeded(pruned):
    art = pruned[0]
    eng = Engine.from_artifact(art, ServeConfig(
        max_seq=16, compute_dtype=torch.float32, cache_dtype=torch.float32))
    prompt = SyntheticCorpus(art.cfg.vocab, seed=0).batch(0, 2, 8)[:, :8]
    a = eng.generate(prompt, 6, temperature=1.0, seed=5)
    b = eng.generate(prompt, 6, temperature=1.0, seed=5)
    assert torch.equal(a, b)
    assert int(a.max()) < art.cfg.vocab


def test_greedy_sampling_masks_padded_vocab():
    logits = torch.zeros((2, 16))
    logits[:, 12] = 5.0           # a padded column may never win
    logits[0, 3] = 1.0
    logits[1, 7] = 1.0
    assert sample_token(logits, 0.0, vocab=10).tolist() == [3, 7]
    assert sample_token(logits, 0.0).tolist() == [12, 12]


def test_serve_launcher_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--recipe", RECIPE, "--sparse", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "sparse fast path" in proc.stdout
    assert "generated (4, 64)" in proc.stdout
