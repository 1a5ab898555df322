"""The port's LoRA adapters and the ``tests/test_system.py`` loop, against
the JAX package on the CPU at f32.

``merge_lora`` on the same (JAX-made) adapters is held within
``MERGE_ATOL``. The system loop trains the small llama-style model for
120 steps in both packages from the same JAX init and the same batches
(the port's ``Trainer`` against JAX's): the port's perplexity must be
within ``PPL_RTOL`` of JAX's. The port then ranks and prunes its own
trained model (unstructured <= composite <= structured, with
``tests/test_system.py``'s slack), serves the composite model and
recovers an unstructured one with LoRA.
"""
import math
import signal

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.core import lora as JLO
from repro.core.registry import projections as jax_projections
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro.train.trainer import Trainer as JaxTrainer
from tests.conftest import small_config

from repro_torch.common.interop import params_from_numpy
from repro_torch.common.tree import leaves, tree_get
from repro_torch.core import lora as LO
from repro_torch.core.pipeline import MosaicPipeline
from repro_torch.core.rank_controller import profile_model
from repro_torch.core.recipe import PruneRecipe
from repro_torch.core.registry import projections
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import Engine
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import value_and_grad
from repro_torch.train.trainer import Trainer

CPU = torch.device("cpu")
MERGE_ATOL = 1e-6    # f32: the same A @ B, summation order aside
PPL_RTOL = 0.01      # trained ppl, port vs JAX, same init and batches


@pytest.fixture(autouse=True, scope="module")
def _keep_sigterm():
    """Each Trainer installs a SIGTERM watcher; give the handler back."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _port_cfg(jcfg):
    return config_from_dict(jax_config_to_dict(jcfg))


def _to_port(jtree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree), CPU)


def _jax_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


# ------------------------------------------------------------- adapters

@pytest.mark.parametrize("kind", ["dense", "hybrid"])
@pytest.mark.parametrize("masked", [False, True])
def test_merge_lora_matches_jax(kind, masked):
    jcfg = small_config(moe=kind == "hybrid", mamba=kind == "hybrid")
    cfg = _port_cfg(jcfg)
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    jad = JLO.init_lora(jax.random.PRNGKey(2), jparams, jcfg, rank=4)
    rng = np.random.default_rng(3)
    jad = {k: {"a": v["a"], "b": jnp.asarray(rng.standard_normal(
        v["b"].shape).astype(np.float32) * 0.1)} for k, v in jad.items()}
    jmasks = None
    if masked:
        jmasks = {p.key: jnp.asarray(rng.random(
            _jax_get(jparams, p.path).shape) < 0.5)
            for p in jax_projections(jcfg)}
    jmerged = JLO.merge_lora(jparams, jcfg, jad, rank=4, masks=jmasks)
    merged = LO.merge_lora(
        _to_port(jparams), cfg,
        {k: _to_port(v) for k, v in jad.items()}, rank=4,
        masks=None if jmasks is None else
        {k: torch.from_numpy(np.array(v)) for k, v in jmasks.items()})
    for proj in projections(cfg):
        got = tree_get(merged, proj.path).numpy()
        want = np.asarray(_jax_get(jmerged, proj.path))
        np.testing.assert_allclose(got, want, atol=MERGE_ATOL, rtol=0)
        if masked:
            base = np.asarray(_jax_get(jparams, proj.path))
            off = ~np.asarray(jmasks[proj.key])
            np.testing.assert_array_equal(got[off], base[off])


def test_init_lora_shapes_match_jax():
    jcfg = small_config(moe=True, mamba=True)
    cfg = _port_cfg(jcfg)
    jparams = jax_T.init_model(jax.random.PRNGKey(0), jcfg)
    jad = JLO.init_lora(jax.random.PRNGKey(1), jparams, jcfg, rank=4)
    ad = LO.init_lora(torch.Generator().manual_seed(1), _to_port(jparams),
                      cfg, rank=4)
    assert set(ad) == set(jad)
    for key, ab in ad.items():
        assert ab["a"].shape == jad[key]["a"].shape
        assert ab["b"].shape == jad[key]["b"].shape
        assert ab["a"].dtype == ab["b"].dtype == torch.float32
        assert not ab["b"].any()
        cin = ab["a"].shape[-2]
        assert 0.5 < float(ab["a"].std()) * math.sqrt(cin) < 1.5


def test_lora_zero_init_is_identity():
    cfg = _port_cfg(small_config(moe=True, mamba=True))
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 8)))
    lo0, _, _ = T.forward(params, cfg, toks, compute_dtype=torch.float32)
    ad = LO.init_lora(torch.Generator().manual_seed(2), params, cfg, rank=4)
    merged = LO.merge_lora(params, cfg, ad, rank=4)
    lo1, _, _ = T.forward(merged, cfg, toks, compute_dtype=torch.float32)
    torch.testing.assert_close(lo0, lo1, atol=1e-6, rtol=0)


def test_lora_merge_respects_masks():
    cfg = _port_cfg(small_config())
    params = T.init_model(torch.Generator().manual_seed(0), cfg)
    ad = LO.init_lora(torch.Generator().manual_seed(2), params, cfg, rank=4)
    ad = {k: {n: t + 0.1 for n, t in v.items()} for k, v in ad.items()}
    masks = {p.key: torch.zeros(tree_get(params, p.path).shape,
                                dtype=torch.bool) for p in projections(cfg)}
    merged = LO.merge_lora(params, cfg, ad, rank=4, masks=masks)
    for proj in projections(cfg):
        assert torch.equal(tree_get(merged, proj.path),
                           tree_get(params, proj.path))


# -------------------------------------------------- the system loop

def _ppl(params, cfg, corpus, n=4) -> float:
    """tests/test_system.py's held-out perplexity, in the port."""
    tot = 0.0
    with torch.no_grad():
        for tokens, labels in corpus.batches(8, 64, start=500, n=n):
            logits, _, _ = T.forward(params, cfg, torch.from_numpy(tokens),
                                     compute_dtype=torch.float32)
            tot += float(T.cross_entropy(logits, torch.from_numpy(labels),
                                         cfg.vocab))
    return math.exp(tot / n)


def _jax_ppl(params, cfg, corpus, n=4) -> float:
    tot = 0.0
    for tokens, labels in corpus.batches(8, 64, start=500, n=n):
        logits, _, _ = jax_T.forward(params, cfg, tokens,
                                     compute_dtype=jnp.float32)
        tot += float(jax_T.cross_entropy(logits, labels, cfg.vocab))
    return math.exp(tot / n)


@pytest.fixture(scope="module")
def trained():
    """Both packages train test_system.py's model from JAX's init on the
    same batches. Returns (port cfg, port params, corpus, port losses,
    JAX losses, JAX ppl)."""
    jcfg = small_config(vocab=256)
    cfg = _port_cfg(jcfg)
    corpus = SyntheticCorpus(256, seed=0)
    ocfg = dict(lr=2e-3, warmup_steps=10, total_steps=150)
    jt = JaxTrainer(jcfg, JaxOptConfig(**ocfg), corpus.batches(16, 64),
                    ckpt=None, compute_dtype=jnp.float32, prefetch=False)
    pt = Trainer(cfg, OPT.OptConfig(**ocfg), corpus.batches(16, 64),
                 ckpt=None, compute_dtype=torch.float32, device="cpu")
    params = _to_port(jt.state["params"])     # JAX's init, before a step
    pt.state = {"params": params,
                "opt": OPT.init_opt(params, OPT.OptConfig(**ocfg))}
    jrep = jt.run(120)
    prep = pt.run(120)
    return (cfg, pt.state["params"], corpus, prep.losses, jrep.losses,
            _jax_ppl(jt.state["params"], jcfg, corpus))


def test_trained_ppl_matches_jax(trained):
    cfg, params, corpus, losses, jlosses, jppl = trained
    assert losses[-1] < losses[0]
    ppl = _ppl(params, cfg, corpus)
    # where the per-step losses part, if the ppl bound ever fails
    drift = [abs(a - b) / b for a, b in zip(losses, jlosses)]
    print(f"trained ppl: port {ppl:.6f}, JAX {jppl:.6f}; largest "
          f"per-step loss drift {max(drift):.3e}")
    assert abs(ppl - jppl) <= PPL_RTOL * jppl, (ppl, jppl, drift)
    assert ppl < 150                       # well below vocab=256


def test_train_prune_eval_ordering(trained):
    cfg, params, corpus, *_ = trained
    base = _ppl(params, cfg, corpus)
    art = profile_model(params, cfg, corpus.calibration_batches(8, 4, 64))
    ppls = {}
    for cat in ("unstructured", "composite", "structured"):
        recipe = PruneRecipe(arch=cfg.name, p=0.3, category=cat,
                             align_channels=8, block=16,
                             stages=("plan", "prune", "report"))
        res = MosaicPipeline(recipe).run(params, cfg, rank_artifact=art)
        ppls[cat] = _ppl(res.params, res.cfg, corpus)
        assert np.isfinite(ppls[cat])
        if cat == "composite":
            eng = Engine(res.params, res.cfg, ServeConfig(
                max_seq=32, compute_dtype=torch.float32,
                cache_dtype=torch.float32))
            out = eng.generate(corpus.batch(900, 2, 8)[:, :8], n_new=8)
            assert out.shape == (2, 16) and bool((out < cfg.vocab).all())
    assert ppls["unstructured"] <= ppls["composite"] * 1.5
    assert ppls["composite"] <= ppls["structured"] * 1.5
    assert base <= ppls["unstructured"] * 1.05


def test_lora_recovery_improves_pruned_model(trained):
    cfg, params, corpus, *_ = trained
    art = profile_model(params, cfg, corpus.calibration_batches(4, 4, 32))
    res = MosaicPipeline(PruneRecipe(
        arch=cfg.name, p=0.5, category="unstructured", block=16,
        stages=("plan", "prune", "report"))).run(params, cfg,
                                                 rank_artifact=art)
    pruned_ppl = _ppl(res.params, res.cfg, corpus)
    adapters = LO.init_lora(torch.Generator().manual_seed(1), res.params,
                            res.cfg, rank=4)

    def loss(ad, tokens, labels):
        merged = LO.merge_lora(res.params, res.cfg, ad, rank=4)
        return T.loss_fn(merged, res.cfg, tokens, labels,
                         compute_dtype=torch.float32)
    ocfg = OPT.OptConfig(lr=5e-3, warmup_steps=5, total_steps=60,
                         weight_decay=0.0)
    ostate = OPT.init_opt(adapters, ocfg)
    grad = value_and_grad(loss)
    for tokens, labels in corpus.batches(16, 64, start=200, n=40):
        _, g = grad(adapters, torch.from_numpy(tokens),
                    torch.from_numpy(labels))
        adapters, ostate, _ = OPT.apply_updates(adapters, g, ostate, ocfg)
    for leaf in leaves(res.params):
        assert not leaf.requires_grad
    recovered = LO.merge_lora(res.params, res.cfg, adapters, rank=4)
    assert _ppl(recovered, res.cfg, corpus) < pruned_ppl
