"""The port's training path against the JAX package, at f32 on the CPU.

Params come from JAX ``init_model`` through numpy; gradients, batches
and optimizer inputs are made with numpy. Held to JAX: AdamW
(``apply_updates``, ``schedule``, clipping) within ``OPT_RTOL``;
``loss_fn`` within ``LOSS_RTOL`` and each gradient leaf within
``GRAD_RTOL`` in the Frobenius norm (dense, MoE, hybrid, and a sequence
above ``DENSE_ATTN_MAX``); 20 train steps, one and two microbatches,
within ``STEP_RTOL`` a step; training checkpoints both ways, unrolled
and scanned. Also the ports of the training cases of
``tests/test_substrate.py``.
"""
import os
import shutil
import signal
import tempfile

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.models import transformer as jax_T
from repro.models.specs import config_to_dict as jax_config_to_dict
from repro.train import optimizer as JOPT
from repro.train.train_step import make_train_step as jax_make_train_step
from repro.train.trainer import Trainer as JaxTrainer
from tests.conftest import small_config
from tests.test_torch_gpu import KERNEL_OPS, check_op_refuses_grad

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.interop import (params_from_numpy, stack_blocks,
                                        unstack_blocks)
from repro_torch.common.tree import iter_paths, leaves, tree_map
from repro_torch.data.pipeline import Prefetcher, SyntheticCorpus
from repro_torch.distributed.fault import (PreemptionHandler,
                                           StragglerMonitor, with_retries)
from repro_torch.launch import train as train_launch
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.specs import config_from_dict
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          value_and_grad)
from repro_torch.train.trainer import Trainer

CPU = torch.device("cpu")
OPT_RTOL = 1e-6      # f32 elementwise: an ulp or two of the same formula
LOSS_RTOL = 1e-5     # f32 forward: matmul and softmax summation order
GRAD_RTOL = 1e-4     # Frobenius norm of a gradient leaf's error
STEP_RTOL = 1e-4     # per-step loss over a run from the same init


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


def _rel_max(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _rel_fro(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _paired_leaves(port_tree, jax_tree) -> list:
    """(path, port numpy, jax numpy) for every leaf, by path."""
    jflat = {tuple(str(getattr(k, "key", getattr(k, "idx", k)))
                   for k in path): np.asarray(leaf)
             for path, leaf in jax.tree_util.tree_flatten_with_path(
                 jax_tree)[0]}
    out = []
    for path, leaf in iter_paths(port_tree):
        key = tuple(str(p) for p in path)
        t = leaf.detach().float() if leaf.is_floating_point() else leaf
        out.append((key, t.numpy(), np.asarray(jflat[key], np.float32)
                    if t.is_floating_point() else jflat[key]))
    assert len(out) == len(jflat)
    return out


# ------------------------------------------------------------- optimizer

def _opt_case(seed: int):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 10)).astype(np.float32),
              "e": rng.standard_normal((3, 4, 5)).astype(np.float32),
              "b": rng.standard_normal((10,)).astype(np.float32)}
    grads = [{k: (rng.standard_normal(v.shape) * s).astype(np.float32)
              for k, v in params.items()} for s in (3.0, 0.01, 1.0)]
    return params, grads


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("m_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_jax(factored, m_dtype):
    params, grads = _opt_case(0)
    cfg = dict(lr=0.05, warmup_steps=2, total_steps=10, weight_decay=0.1,
               factored=factored, m_dtype=m_dtype)
    jcfg, pcfg = JOPT.OptConfig(**cfg), OPT.OptConfig(**cfg)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    js = JOPT.init_opt(jp, jcfg)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = OPT.init_opt(pp, pcfg)
    for g in grads:            # the first step clips, the second does not
        jp, js, jstats = JOPT.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g), js, jcfg)
        pp, ps, pstats = OPT.apply_updates(
            pp, {k: torch.from_numpy(v) for k, v in g.items()}, ps, pcfg)
        assert _rel_max(pstats["grad_norm"], jstats["grad_norm"]) <= OPT_RTOL
        assert _rel_max(pstats["lr"], jstats["lr"]) <= OPT_RTOL
    assert int(ps["step"]) == int(js["step"]) == 3
    assert ps["m"]["w"].dtype == getattr(torch, m_dtype)
    for tree_p, tree_j in ((pp, jp), (ps["m"], js["m"]), (ps["v"], js["v"])):
        for _, got, want in _paired_leaves(tree_p, tree_j):
            assert _rel_max(got, want) <= OPT_RTOL
    if factored:
        assert set(ps["v"]["w"]) == {"row", "col"}
        assert set(ps["v"]["b"]) == {"full"}


def test_schedule_matches_jax():
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    for step in (0, 5, 10, 55, 100, 130):
        got = OPT.schedule(OPT.OptConfig(**cfg),
                           torch.tensor(step, dtype=torch.int32))
        want = JOPT.schedule(JOPT.OptConfig(**cfg), jnp.int32(step))
        np.testing.assert_allclose(float(got), float(want), rtol=OPT_RTOL,
                                   atol=0)


def test_clip_by_global_norm_matches_jax():
    _, grads = _opt_case(1)
    g = grads[0]
    jc, jn = JOPT.clip_by_global_norm(
        jax.tree_util.tree_map(jnp.asarray, g), 1.0)
    pc, pn = OPT.clip_by_global_norm(
        {k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    assert _rel_max(pn, jn) <= OPT_RTOL
    for _, got, want in _paired_leaves(pc, jc):
        assert _rel_max(got, want) <= OPT_RTOL


# ------------------------------------------------------- loss and grads

CONFIGS = {"dense": dict(), "moe": dict(moe=True),
           "hybrid": dict(moe=True, mamba=True)}


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    """(name, jax cfg, port cfg, jax params, port params)."""
    jcfg = small_config(**CONFIGS[request.param])
    jparams = jax_T.init_model(jax.random.PRNGKey(3), jcfg)
    return (request.param, jcfg, _port_cfg(jcfg), jparams,
            _to_port(jparams))


def _batch(seed: int, B: int, S: int, vocab: int = 256):
    full = SyntheticCorpus(vocab, seed=seed).batch(0, B, S)
    return full[:, :-1], full[:, 1:]


def _jax_grad(jparams, jcfg, tok, lab):
    f = jax.jit(jax.value_and_grad(jax_T.loss_fn, has_aux=True),
                static_argnames=("cfg", "compute_dtype"))
    return f(jparams, jcfg, jnp.asarray(tok), jnp.asarray(lab),
             compute_dtype=jnp.float32)


def _port_grad(params, cfg, tok, lab):
    fn = value_and_grad(lambda p, t, lb: T.loss_fn(
        p, cfg, t, lb, compute_dtype=torch.float32))
    return fn(params, torch.from_numpy(tok), torch.from_numpy(lab))


def _check_loss_and_grads(jout, pout) -> None:
    (jl, (jce, jaux)), jg = jout
    (pl, (pce, paux)), pg = pout
    assert _rel_max(pl, jl) <= LOSS_RTOL
    assert _rel_max(pce, jce) <= LOSS_RTOL
    assert abs(float(paux) - float(jaux)) <= LOSS_RTOL * max(
        1.0, abs(float(jaux)))
    for key, got, want in _paired_leaves(pg, jg):
        assert _rel_fro(got, want) <= GRAD_RTOL, key


def test_loss_and_grads_match_jax(model):
    name, jcfg, cfg, jparams, params = model
    tok, lab = _batch(4, 2, 24)
    jout = _jax_grad(jparams, jcfg, tok, lab)
    pout = _port_grad(params, cfg, tok, lab)
    _check_loss_and_grads(jout, pout)
    if name != "dense":
        assert float(pout[0][1][1]) > 0          # the MoE aux loss
    for leaf in leaves(params):
        assert not leaf.requires_grad


def test_loss_and_grads_match_jax_above_dense_attn_max():
    jcfg = small_config()
    jparams = jax_T.init_model(jax.random.PRNGKey(5), jcfg)
    S = 3 * L.Q_CHUNK
    assert S > L.DENSE_ATTN_MAX
    tok, lab = _batch(6, 1, S)
    _check_loss_and_grads(_jax_grad(jparams, jcfg, tok, lab),
                          _port_grad(_to_port(jparams), _port_cfg(jcfg),
                                     tok, lab))


def test_remat_is_bitwise_equal_to_no_remat(model):
    _, _, cfg, _, params = model
    tok, lab = _batch(7, 2, 16)
    (l0, _), g0 = _port_grad(params, cfg.replace(remat=False), tok, lab)
    (l1, _), g1 = _port_grad(params, cfg.replace(remat=True), tok, lab)
    assert torch.equal(l0, l1)
    for a, b in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)


# ------------------------------------------------------------ train step

@pytest.mark.parametrize("name,n_micro", [("dense", 1), ("hybrid", 2)])
def test_train_step_matches_jax_over_20_steps(name, n_micro):
    jcfg = small_config(**CONFIGS[name])
    cfg = _port_cfg(jcfg)
    ocfg = dict(lr=2e-3, warmup_steps=5, total_steps=40)
    jparams = jax_T.init_model(jax.random.PRNGKey(8), jcfg)
    jstate = {"params": jparams,
              "opt": JOPT.init_opt(jparams, JOPT.OptConfig(**ocfg))}
    state = {"params": _to_port(jparams)}
    state["opt"] = OPT.init_opt(state["params"], OPT.OptConfig(**ocfg))
    jstep = jax.jit(jax_make_train_step(
        jcfg, JOPT.OptConfig(**ocfg), n_microbatches=n_micro,
        compute_dtype=jnp.float32))
    step = make_train_step(cfg, OPT.OptConfig(**ocfg),
                           n_microbatches=n_micro,
                           compute_dtype=torch.float32)
    jl, pl = [], []
    for tok, lab in SyntheticCorpus(256, seed=2).batches(4, 16, n=20):
        jstate, jm = jstep(jstate, jnp.asarray(tok), jnp.asarray(lab))
        state, m = step(state, torch.from_numpy(tok), torch.from_numpy(lab))
        jl.append(float(jm["loss"]))
        pl.append(float(m["loss"]))
        assert _rel_max(m["grad_norm"], jm["grad_norm"]) <= 1e-3
    np.testing.assert_allclose(pl, jl, rtol=STEP_RTOL, atol=0)
    assert pl[-1] < pl[0]


def test_microbatches_average_like_one_batch():
    cfg = _port_cfg(small_config())
    ocfg = OPT.OptConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    tok, lab = _batch(9, 4, 16)
    out = []
    for n in (1, 2):
        gen = torch.Generator().manual_seed(0)
        state = init_train_state(gen, cfg, ocfg)
        state, m = make_train_step(cfg, ocfg, n_microbatches=n,
                                   compute_dtype=torch.float32)(
            state, torch.from_numpy(tok), torch.from_numpy(lab))
        out.append((float(m["loss"]), state["params"]))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for a, b in zip(leaves(out[0][1]), leaves(out[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(cfg, ocfg, n_microbatches=3)(
            state, torch.from_numpy(tok), torch.from_numpy(lab))


# ----------------------------------------------------------- checkpoints

def _jax_trainer(jcfg, d, start=0):
    corpus = SyntheticCorpus(256, seed=1)
    return JaxTrainer(jcfg, JOPT.OptConfig(**OCFG),
                      corpus.batches(4, 16, start=start),
                      ckpt=JaxCheckpointManager(d), ckpt_every=100,
                      compute_dtype=jnp.float32, prefetch=False,
                      async_checkpoint=False)


def _port_trainer(cfg, d, start=0):
    corpus = SyntheticCorpus(256, seed=1)
    return Trainer(cfg, OPT.OptConfig(**OCFG),
                   corpus.batches(4, 16, start=start),
                   ckpt=CheckpointManager(d) if d else None, ckpt_every=100,
                   compute_dtype=torch.float32, prefetch=False,
                   device="cpu")


OCFG = dict(lr=2e-3, warmup_steps=3, total_steps=30)


@pytest.mark.parametrize("scan", [False, True])
def test_jax_checkpoint_continues_in_the_port(scan):
    jcfg = small_config(scan=scan, moe=True)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "jax"), os.path.join(d, "port")
        jt = _jax_trainer(jcfg, a)
        jt.run(4)
        shutil.copytree(a, b)
        jrep = jt.run(4)
        pt = _port_trainer(_port_cfg(jcfg), b, start=4)
        assert pt.step == 4
        prep = pt.run(4)
    np.testing.assert_allclose(prep.losses, jrep.losses, rtol=STEP_RTOL,
                               atol=0)


@pytest.mark.parametrize("scan", [False, True])
def test_port_checkpoint_continues_in_jax(scan):
    jcfg = small_config(scan=scan, moe=True)
    with tempfile.TemporaryDirectory() as d:
        a, b = os.path.join(d, "port"), os.path.join(d, "jax")
        pt = _port_trainer(_port_cfg(jcfg), a)
        pt.run(4)
        shutil.copytree(a, b)
        with np.load(os.path.join(b, "step_00000004", "arrays.npz")) as z:
            if scan:     # the port wrote JAX's scanned layout
                assert z["params/blocks/0/attn/q"].shape == (2, 64, 4, 16)
                assert z["opt/v/blocks/1/moe/up"].shape == (2, 4, 64, 64)
            else:
                assert z["opt/m/blocks/3/moe/up"].shape == (4, 64, 64)
        prep = pt.run(4)
        jt = _jax_trainer(jcfg, b, start=4)
        assert jt.step == 4
        jrep = jt.run(4)
    np.testing.assert_allclose(jrep.losses, prep.losses, rtol=STEP_RTOL,
                               atol=0)


def test_scanned_and_unrolled_blocks_round_trip_bitwise():
    jcfg = small_config(scan=True, moe=True)
    jparams = jax_T.init_model(jax.random.PRNGKey(2), jcfg)
    scanned = _to_port(jparams)
    P, n = len(jcfg.pattern), jcfg.n_periods
    blocks = unstack_blocks(scanned["blocks"], n)
    assert len(blocks) == P * n
    for i, blk in enumerate(blocks):
        slots = iter_paths(scanned["blocks"][i % P])
        for (path, got), (_, slot) in zip(iter_paths(blk), slots):
            assert torch.equal(got, slot[i // P]), (i, path)
    back = stack_blocks(blocks, P)
    for a, b in zip(leaves(back), leaves(scanned["blocks"])):
        assert torch.equal(a, b)
    # the unstacked params are the unrolled model JAX's scan computes
    cfg = _port_cfg(jcfg).unrolled()
    tok = np.random.default_rng(0).integers(0, 256, (2, 12), np.int32)
    want, _, _ = jax_T.forward(jparams, jcfg, jnp.asarray(tok),
                               compute_dtype=jnp.float32)
    got, _, _ = T.forward({**scanned, "blocks": blocks}, cfg,
                          torch.from_numpy(tok), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def test_preempted_trainer_resumes_to_the_same_losses():
    cfg = _port_cfg(small_config(moe=True))
    full = _port_trainer(cfg, None).run(8)
    with tempfile.TemporaryDirectory() as d:
        tr = _port_trainer(cfg, d)
        tr.async_checkpoint = True
        tr.log_fn = lambda s, m: tr.preemption.trigger() if s == 5 else None
        first = tr.run(8)
        assert first.preempted and first.final_step == 5
        assert CheckpointManager(d).latest_step() == 5
        tr.preemption.uninstall()
        rest = _port_trainer(cfg, d, start=5).run(3)
    assert first.losses + rest.losses == full.losses


def test_bf16_momentum_checkpoint_restores_through_the_port():
    cfg = _port_cfg(small_config())
    ocfg = OPT.OptConfig(**OCFG, m_dtype="bfloat16")
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(cfg, ocfg, SyntheticCorpus(256).batches(2, 8),
                     ckpt=CheckpointManager(d), prefetch=False,
                     compute_dtype=torch.float32, device="cpu")
        tr.run(2)
        again = Trainer(cfg, ocfg, SyntheticCorpus(256).batches(2, 8),
                        ckpt=CheckpointManager(d), prefetch=False,
                        compute_dtype=torch.float32, device="cpu",
                        seed=1)
    assert again.step == 2
    for (p, a), (_, b) in zip(iter_paths(tr.state), iter_paths(again.state)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert again.state["opt"]["m"]["embed"]["table"].dtype == torch.bfloat16


def test_train_launcher_resumes_on_cpu(capsys):
    with tempfile.TemporaryDirectory() as d:
        argv = ["--arch", "llama3-8b", "--smoke", "--steps", "20",
                "--batch", "2", "--seq", "16", "--ckpt-dir", d,
                "--ckpt-every", "10", "--device", "cpu"]
        rep = train_launch.main(argv)
        assert rep.steps_run == 20 and rep.final_step == 20
        assert "step    20  loss" in capsys.readouterr().out
        rep2 = train_launch.main(argv[:4] + ["30"] + argv[5:])
    assert rep2.steps_run == 10 and rep2.final_step == 30
    assert "done: 10 steps" in capsys.readouterr().out


@pytest.mark.parametrize("kernel", KERNEL_OPS)
def test_kernel_op_refuses_inputs_that_require_grad_on_the_cpu(kernel):
    """On CPU tensors too: the plain version runs only without grad
    (and launches nothing)."""
    assert check_op_refuses_grad(CPU, kernel) == {}


def test_train_forward_takes_the_plain_paths_on_the_cpu():
    """The train route runs the same arithmetic as the serving forward
    on CPU tensors (both are the plain versions there)."""
    jcfg = small_config(moe=True, mamba=True)
    cfg = _port_cfg(jcfg)
    params = T.init_model(torch.Generator().manual_seed(4), cfg)
    tok = torch.from_numpy(_batch(1, 1, 2 * L.Q_CHUNK + L.Q_CHUNK)[0])
    with torch.no_grad():
        a, _, aux_a = T.forward(params, cfg, tok,
                                compute_dtype=torch.float32)
        b, _, aux_b = T.forward(params, cfg.replace(remat=True), tok,
                                compute_dtype=torch.float32, train=True)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ------------------------------------------ ports of tests/test_substrate

def test_prefetcher_preserves_order():
    it = iter([(i, i) for i in range(10)])
    assert list(Prefetcher(it, depth=3)) == [(i, i) for i in range(10)]


def test_adamw_decreases_quadratic_loss():
    cfg = OPT.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = OPT.init_opt(params, cfg)
    grad = value_and_grad(lambda p: ((p["w"] ** 2).sum(), ()))
    for _ in range(60):
        _, g = grad(params)
        params, state, _ = OPT.apply_updates(params, g, state, cfg)
    assert float(params["w"].abs().max()) < 0.5


@pytest.mark.parametrize("factored", [False, True])
def test_opt_state_shapes(factored):
    cfg = OPT.OptConfig(factored=factored)
    params = {"w": torch.ones((8, 16)), "b": torch.ones((16,))}
    st = OPT.init_opt(params, cfg)
    g = tree_map(lambda x: x * 0.1, params)
    new_p, new_s, stats = OPT.apply_updates(params, g, st, cfg)
    assert new_p["w"].shape == (8, 16)
    assert float(stats["grad_norm"]) > 0
    if factored:
        assert new_s["v"]["w"]["row"].shape == (8,)
        assert new_s["v"]["w"]["col"].shape == (16,)


def test_schedule_warmup_and_decay():
    cfg = OPT.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    sched = lambda s: float(OPT.schedule(cfg, torch.tensor(s)))
    assert sched(5) == pytest.approx(0.5)
    assert sched(10) == pytest.approx(1.0, abs=1e-3)
    assert sched(100) == pytest.approx(cfg.min_lr_frac, abs=1e-3)


def test_grad_clip():
    clipped, norm = OPT.clip_by_global_norm({"w": torch.ones(4) * 10}, 1.0)
    assert float(norm) == pytest.approx(20.0)
    assert float(clipped["w"].norm()) == pytest.approx(1.0, rel=1e-4)


def test_checkpoint_roundtrip_and_retention():
    params = T.init_model(torch.Generator().manual_seed(0),
                          _port_cfg(small_config()))
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=2)
        for step in (1, 2, 3):
            mgr.save(step, params, blocking=True)
        assert mgr.all_steps() == [2, 3]
        restored = mgr.restore(tree_map(torch.zeros_like, params))
    for a, b in zip(leaves(params), leaves(restored)):
        assert torch.equal(a, b)


def test_checkpoint_async_and_atomic():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d, keep=3)
        tree = {"x": torch.arange(1000.0)}
        mgr.save(7, tree, blocking=False)
        tree["x"].add_(1.0)          # after the call: not in the file
        mgr.wait()
        assert mgr.latest_step() == 7
        assert not any(n.endswith(".tmp") for n in os.listdir(d))
        assert mgr.meta()["step"] == 7
        assert mgr.save_seconds > 0
        got = mgr.restore({"x": torch.zeros(1000)})
    assert torch.equal(got["x"], torch.arange(1000.0))


def test_jax_reads_the_port_async_checkpoint():
    with tempfile.TemporaryDirectory() as d:
        mgr = CheckpointManager(d)
        mgr.save(3, {"a": {"b": torch.arange(6.0).reshape(2, 3)},
                     "s": torch.tensor(3, dtype=torch.int32)},
                 blocking=False, extra_meta={"step": 3})
        mgr.wait()
        got = JaxCheckpointManager(d).restore(
            {"a": {"b": jnp.zeros((2, 3))}, "s": jnp.zeros((), jnp.int32)})
    np.testing.assert_array_equal(np.asarray(got["a"]["b"]),
                                  np.arange(6.0).reshape(2, 3))
    assert int(got["s"]) == 3


def test_preemption_handler():
    h = PreemptionHandler().install()
    assert not h.should_stop
    h.trigger()
    assert h.should_stop
    h.uninstall()


def test_straggler_monitor_flags_slow_steps():
    m = StragglerMonitor(threshold=2.0, warmup=2)
    for i in range(10):
        m.record(i, 0.1)
    assert m.record(10, 0.5)
    assert not m.record(11, 0.11)
    assert len(m.flagged) == 1
    assert m.ema == pytest.approx(0.1, rel=0.15)


def test_with_retries():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise IOError("transient")
        return "ok"
    assert with_retries(flaky, n_retries=3, backoff=0.0)() == "ok"
    assert calls["n"] == 3
    with pytest.raises(IOError):
        with_retries(lambda: (_ for _ in ()).throw(IOError("x")),
                     n_retries=1, backoff=0.0)()
