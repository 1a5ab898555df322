"""The port's distribution layer against the JAX package, on the CPU.

In-process: the spec functions (``param_specs``, ``cache_specs``,
``input_sharding``, ``resolve_spec``, ``choose_mesh_shape``, and the
dry-run's ``opt_specs``) equal the JAX package's as tuples for every
registry id, scanned and unrolled, on five meshes (the JAX functions read only ``mesh.shape``, so they take a
stub); ``launch/specs.py``'s meta structs equal JAX's ``eval_shape``
structs; int8 compression is bitwise JAX's.

Multi-rank cases run as JAX's own do, in a subprocess: the parent
computes the JAX references and writes the inputs to an ``.npz``; a
``python -c`` child that imports only ``repro_torch`` spawns gloo ranks
on 127.0.0.1, and prints one JSON line. Two worlds: 8 ranks (a 2x2x2
``pod`` x ``data`` x ``model`` mesh: the tuple-axis order, the
compressed all-reduce, the sharded forward, decode and padded-heads
forward, every sharded gradient leaf, two sharded train steps,
checkpoints both ways, the elastic mesh, and the Trainer with a
factored second moment from a JAX checkpoint) and 4 ranks (the pipeline, then the train launcher on 2 of them).
The dry-run cell runs alone after them, in a third subprocess; its flop
count is checked in-process on a fake world of 4.
"""
import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.checkpoint.manager import CheckpointManager as JaxCheckpointManager
from repro.configs import registry as jreg
from repro.configs import shapes as jshapes
from repro.distributed import axes as JAX_AX
from repro.distributed import compression as JC
from repro.distributed import elastic as JEL
from repro.distributed import sharding as JSH
from repro.launch import specs as JSPEC
from repro.models import transformer as JT
from repro.models.specs import (AttentionSpec, LayerSpec, MambaSpec,
                                MLPSpec, ModelConfig, MoESpec)
from repro.serve.engine import make_serve_step as jax_make_serve_step
from repro.train import optimizer as JOPT
from repro.train.train_step import make_loss_fn as jax_make_loss_fn
from repro.train.train_step import make_train_step as jax_make_train_step

from tests.test_torch_gpu import KERNEL_OPS, check_op_refuses_dtensor

from repro_torch.common.tree import iter_paths
from repro_torch.configs import registry as treg
from repro_torch.configs import shapes as tshapes
from repro_torch.distributed import axes as AX
from repro_torch.distributed import compression as TC
from repro_torch.distributed import elastic as TEL
from repro_torch.distributed import sharding as TSH
from repro_torch.launch import specs as TSPEC
from repro_torch.launch import train as train_launch
from repro_torch.train import optimizer as TOPT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = [{"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 2, "model": 4}, {"data": 1, "model": 8},
          {"data": 8, "model": 1}]
FWD_ATOL = 1e-4      # JAX's own bound for its sharded f32 forward
PIPE_ATOL = 1e-6     # JAX's own bound for its pipeline
STEP_RTOL = 1e-5     # two sharded AdamW steps, f32, per loss and leaf
GRAD_RTOL = 1e-4     # tests/test_torch_train.py's bound for a gradient leaf
# Adam's early steps divide each gradient element by its own magnitude,
# so an element whose gradient is at the level of f32 summation-order
# noise moves by a full lr either way; an eps well above that noise
# keeps the update a smooth function of the gradient, so the comparison
# measures the sharded arithmetic, not the noise's sign.
TRAIN_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10, eps=1e-3)
LAUNCH_ARGV = ["--smoke", "--steps", "20", "--batch", "4", "--seq", "32",
               "--device", "cpu"]


class _Mesh:
    """What JAX's spec functions read of a mesh: its axis sizes."""

    def __init__(self, shape: dict):
        self.shape = shape


def _jspec(tree):
    return jax.tree.map(lambda s: tuple(s), tree,
                        is_leaf=lambda x: isinstance(x, P))


def _flat(tree) -> dict:
    """{path: numpy array} of a JAX tree, keyed as the port's paths."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        out[key] = np.asarray(leaf)
    return out


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _hybrid(scan=True) -> ModelConfig:
    """tests/test_distributed.py's hybrid config."""
    attn = AttentionSpec(n_q=4, n_kv=2, head_dim=16)
    return ModelConfig(
        name="t", d_model=64, vocab=256, vocab_pad_multiple=16,
        pattern=(LayerSpec(attn, MLPSpec(d_ff=128)),
                 LayerSpec(MambaSpec(d_inner=128, d_state=16, head_dim=16,
                                     chunk=8),
                           MoESpec(n_experts=4, top_k=2, d_ff=64))),
        n_periods=2, scan_layers=scan, remat=False)


def _dense(n_q=4, n_kv=2) -> ModelConfig:
    return ModelConfig(
        name="t", d_model=64, vocab=256, vocab_pad_multiple=16,
        pattern=(LayerSpec(AttentionSpec(n_q=n_q, n_kv=n_kv, head_dim=16),
                           MLPSpec(d_ff=128)),),
        n_periods=2, scan_layers=False, remat=False)


def _cfg_json(cfg: ModelConfig) -> str:
    from repro.models.specs import config_to_dict
    return json.dumps(config_to_dict(cfg))


# ------------------------------------------------------ the rank programs

RANKS = r'''
import contextlib, io, json, os
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _run(rank, world, port, name, path):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        out = globals()[name](rank, world, path)
        if rank == 0:
            with open(os.path.join(path, name + ".json"), "w") as f:
                json.dump(out, f)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main(name, world, path):
    from repro_torch.launch.mesh import free_port
    mp.spawn(_run, args=(world, free_port(), name, path), nprocs=world,
             join=True)
    print(open(os.path.join(path, name + ".json")).read(), flush=True)


def _cfg(d, key):
    from repro_torch.models.specs import config_from_dict
    return config_from_dict(json.loads(str(d[key])))


def _load(d, prefix, like):
    from repro_torch.common.tree import iter_paths, tree_set
    tree = like
    for p, leaf in iter_paths(like):
        key = prefix + "/".join(str(k) for k in p)
        tree = tree_set(tree, p, torch.from_numpy(np.array(d[key])))
    return tree


def _lap(res, name):
    import time
    now = time.perf_counter()
    res.setdefault("seconds", {})[name] = now - res.get("_t", now)
    res["_t"] = now


def _all(flag):
    t = torch.tensor(int(bool(flag)))
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t)


def _gather_rows(x):
    out = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(out, x.contiguous())
    return torch.stack(out)


def world8(rank, world, path):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.common.tree import iter_paths, tree_get
    from repro_torch.distributed import axes as AX
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.compression import compressed_all_reduce
    from repro_torch.distributed.elastic import make_elastic_mesh
    from repro_torch.launch import specs as SPEC
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serve.engine import make_serve_step
    from repro_torch.train import optimizer as OPT
    from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                              value_and_grad)
    from repro_torch.train.trainer import Trainer
    d = np.load(os.path.join(path, "in8.npz"))
    res, arrays = {}, {}
    f32 = torch.float32
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), "cpu")

    _lap(res, 'setup')
    # a dim over the tuple (pod, data): pod major, as in JAX
    x = torch.arange(32.0).reshape(8, 4)
    p, q, _ = mesh.get_coordinate()
    blk = p * 2 + q
    local = SH.distribute(x, mesh, (("pod", "data"), None)).to_local()
    res["tuple_order"] = _all(torch.equal(local, x[2 * blk:2 * blk + 2]))

    _lap(res, 'tuple')
    # int8-compressed all-reduce over an 8-rank pod axis, two steps
    pods = make_mesh((8,), ("pod",), "cpu")
    red1, e1 = compressed_all_reduce(
        {"g": torch.from_numpy(d["g1"][rank])}, pods, "pod")
    red2, e2 = compressed_all_reduce(
        {"g": torch.from_numpy(d["g2"][rank])}, pods, "pod", e1)
    arrays.update(red1=red1["g"], red2=red2["g"],
                  e1=_gather_rows(e1["g"]), e2=_gather_rows(e2["g"]))

    _lap(res, 'compress')
    # sharded forward and decode of the hybrid config (scanned params)
    cfg = _cfg(d, "hybrid_cfg")
    run = cfg.unrolled()
    params = _load(d, "hybrid/", SPEC.param_struct(cfg, f32))
    sp = SH.shard_params(params, mesh, cfg)
    toks = torch.from_numpy(d["tokens"])
    with AX.use_mesh(mesh):
        lo = T.forward(sp, run, SH.shard_inputs(toks, mesh),
                       compute_dtype=f32)[0]
    arrays["fwd"] = lo.full_tensor()
    _lap(res, 'forward')
    cache = SH.shard_cache(T.init_cache(run, 8, 32, f32), mesh, cfg, 8)
    res["cache_placements"] = str(cache[1]["mamba"]["state"].placements)
    with AX.use_mesh(mesh):
        lo1, _ = make_serve_step(run, compute_dtype=f32)(
            sp, cache, SH.shard_inputs(toks[:, :1], mesh), 0)
    arrays["dec"] = lo1.full_tensor()

    _lap(res, 'decode')
    # heads that do not divide 'model': the expand-and-pad layout
    mesh24 = make_mesh((2, 4), ("data", "model"), "cpu")
    pcfg = _cfg(d, "padded_cfg")
    pp = _load(d, "padded/", SPEC.param_struct(pcfg, f32))
    with AX.use_mesh(mesh24):
        lo = T.forward(SH.shard_params(pp, mesh24, pcfg), pcfg,
                       SH.shard_inputs(toks, mesh24), compute_dtype=f32)[0]
    arrays["padded"] = lo.full_tensor()

    _lap(res, 'padded')
    # the sharded gradient of every leaf, before the steps update sp
    pspecs = SH.param_specs(mesh, run)
    grad_fn = value_and_grad(make_loss_fn(run, f32, mesh=mesh,
                                          param_specs=pspecs))
    with AX.use_mesh(mesh):
        (loss, _), grads = grad_fn(
            sp, SH.shard_inputs(torch.from_numpy(d["train_tok"][0]), mesh),
            SH.shard_inputs(torch.from_numpy(d["train_lab"][0]), mesh))
    res["grad_loss"] = float(loss)
    for p_, leaf in iter_paths(grads):
        arrays["grad/" + "/".join(str(k) for k in p_)] = leaf.full_tensor()

    _lap(res, 'grads')
    # two sharded AdamW steps, then a checkpoint of the sharded params
    ocfg = OPT.OptConfig(**json.loads(str(d["opt_cfg"])))
    state = {"params": sp, "opt": OPT.init_opt(sp, ocfg)}
    step = make_train_step(run, ocfg, compute_dtype=f32, mesh=mesh,
                           param_specs=pspecs)
    losses = []
    for i in range(2):
        state, m = step(state, torch.from_numpy(d["train_tok"][i]),
                        torch.from_numpy(d["train_lab"][i]))
        losses.append(float(m["loss"]))
    res["losses"] = losses
    for p_, leaf in iter_paths(state["params"]):
        arrays["trained/" + "/".join(str(k) for k in p_)] = \
            leaf.full_tensor()
    CheckpointManager(os.path.join(path, "ckpt_port")).save(
        2, {"params": state["params"]}, blocking=True)

    _lap(res, 'train')
    # a JAX-written checkpoint onto an elastic mesh of the 8 ranks
    emesh = make_elastic_mesh(8, target_tp=2)
    res["elastic_shape"] = list(emesh.shape)
    ecfg = _cfg(d, "elastic_cfg")
    like = T.init_model(None, ecfg)
    got = CheckpointManager(os.path.join(path, "ckpt_jax")).restore(
        like, shardings=SH.param_shardings(emesh, ecfg))
    ok, sharded = True, 0
    for p_, leaf in iter_paths(got):
        want = torch.from_numpy(np.array(d["elastic/" + "/".join(
            str(k) for k in p_)]))
        sharded += any(pl.is_shard() for pl in leaf.placements)
        ok = ok and torch.equal(leaf.full_tensor(), want)
    res["elastic_bitwise"] = _all(ok)
    res["elastic_sharded_leaves"] = sharded
    _lap(res, 'elastic')
    # the factored Trainer from a JAX checkpoint (scanned layout)
    focfg = OPT.OptConfig(**json.loads(str(d["opt_cfg"])), factored=True)
    tr = Trainer(cfg, focfg, iter(zip(d["train_tok"], d["train_lab"])),
                 ckpt=CheckpointManager(os.path.join(path, "ckpt_factored")),
                 compute_dtype=f32, prefetch=False, async_checkpoint=False,
                 device="cpu", mesh=mesh)
    try:
        res["factored_start"] = tr.step
        jax_params = _load(d, "hybrid/", SPEC.param_struct(cfg, f32))
        jax_params["blocks"] = SH.unrolled_blocks(jax_params["blocks"], cfg)
        res["factored_restored"] = _all(all(
            torch.equal(leaf.full_tensor(), want)
            for (_, leaf), (_, want) in zip(iter_paths(tr.state["params"]),
                                            iter_paths(jax_params))))
        res["factored_losses"] = tr.run(2).losses
    finally:
        tr.preemption.uninstall()
    vspecs = SH.opt_specs(SH.param_specs(mesh, cfg),
                          SPEC.param_struct(cfg), focfg)["v"]
    placed, n_sharded = True, {"row": 0, "col": 0, "full": 0}
    for p_, leaf in iter_paths(tr.state["opt"]["v"]):
        pl = tuple(AX.spec_placements(mesh, tree_get(vspecs, p_)))
        placed = placed and tuple(leaf.placements) == pl
        n_sharded[p_[-1]] += any(x.is_shard() for x in leaf.placements)
    res["factored_v_placed"] = _all(placed)
    res["factored_v_sharded"] = n_sharded
    for name in ("params", "m", "v"):
        tree = tr.state[name] if name == "params" else tr.state["opt"][name]
        for p_, leaf in iter_paths(tree):
            arrays[f"factored/{name}/" + "/".join(str(k) for k in p_)] = \
                leaf.full_tensor()
    _lap(res, 'factored')
    # an unrolled JAX factored state restored onto the mesh
    ucfg = _cfg(d, "unrolled_cfg")
    tr = Trainer(ucfg, focfg, iter(()),
                 ckpt=CheckpointManager(os.path.join(path, "ckpt_unrolled")),
                 compute_dtype=f32, prefetch=False, device="cpu", mesh=mesh)
    tr.preemption.uninstall()
    res["unrolled_start"] = tr.step
    vspecs = SH.opt_specs(SH.param_specs(mesh, ucfg),
                          SPEC.param_struct(ucfg), focfg)["v"]
    res["unrolled_v_placed"] = _all(all(
        tuple(leaf.placements) == tuple(AX.spec_placements(
            mesh, tree_get(vspecs, p_)))
        for p_, leaf in iter_paths(tr.state["opt"]["v"])))
    for p_, leaf in iter_paths(tr.state):
        arrays["restored/" + "/".join(str(k) for k in p_)] = \
            AX.full(leaf)
    _lap(res, 'unrolled')
    if rank == 0:
        np.savez(os.path.join(path, "out8.npz"),
                 **{k: v.numpy() for k, v in arrays.items()})
    return res


def world4(rank, world, path):
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_mesh
    d = np.load(os.path.join(path, "in4.npz"))
    mesh = make_mesh((4,), ("stage",), "cpu")
    ws = SH.distribute(torch.from_numpy(d["Ws"]), mesh, ("stage", None, None))
    out = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"]), {"w": ws},
                           torch.from_numpy(d["x"]), mesh, axis="stage")
    res = {"pipeline": out.numpy().tolist()}
    dist.destroy_process_group()
    if rank < 2:                   # the launcher on a world of 2 ranks
        os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                          MASTER_ADDR="127.0.0.1",
                          MASTER_PORT=str(int(d["port2"])))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            train.main(list(d["argv"]) + ["--mesh", "host"])
        res["launch"] = buf.getvalue()
    return res
'''


class _Run:
    """A subprocess started now and read once, when a test needs it. Its
    output goes to files, so a child never waits on a full pipe."""

    def __init__(self, argv: list, logs):
        env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
                   OMP_NUM_THREADS="1")
        self.files = [open(logs / name, "w+") for name in ("out", "err")]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv, env=env, cwd=REPO,
                                     stdout=self.files[0],
                                     stderr=self.files[1], text=True)
        self.out = None

    def finish(self, timeout: int = 300):
        """(stdout, stderr, seconds from start to exit); raises on a
        non-zero exit."""
        if self.out is None:
            self.proc.wait(timeout=timeout)
            seconds = time.perf_counter() - self.t0
            out, err = (f.seek(0) or f.read() for f in self.files)
            self.out = (out, err, seconds)
            assert self.proc.returncode == 0, f"stderr:\n{err[-4000:]}"
        return self.out

    def json(self) -> dict:
        return json.loads(self.finish()[0].strip().splitlines()[-1])

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        for f in self.files:
            f.close()


def _ranks(path, name: str, world: int) -> _Run:
    """The rank program ``name`` on ``world`` gloo ranks."""
    (path / "ranks.py").write_text(RANKS)
    prog = (f"import sys; sys.path.insert(0, {str(path)!r}); "
            f"import ranks; ranks.main({name!r}, {world}, {str(path)!r})")
    return _Run([sys.executable, "-c", prog], path)


def _world8_inputs(path) -> dict:
    """The 8-rank world's inputs (written to ``in8.npz``) and the JAX
    trees its references come from."""
    rng = np.random.default_rng(0)
    hybrid, padded, elastic = _hybrid(scan=True), _dense(6, 2), _dense()
    trees = {"hybrid": JT.init_model(jax.random.PRNGKey(0), hybrid),
             "padded": JT.init_model(jax.random.PRNGKey(1), padded),
             "elastic": JT.init_model(jax.random.PRNGKey(2), elastic)}
    JaxCheckpointManager(str(path / "ckpt_jax")).save(1, trees["elastic"],
                                                      blocking=True)
    # the factored Trainer's starting state, in JAX's scanned layout
    factored = JOPT.OptConfig(**TRAIN_OPT, factored=True)
    JaxCheckpointManager(str(path / "ckpt_factored")).save(
        0, {"params": trees["hybrid"],
            "opt": JOPT.init_opt(trees["hybrid"], factored)},
        blocking=True, extra_meta={"step": 0})
    # an unrolled factored state whose moments are not zero
    unrolled, fill = _hybrid(scan=False), np.random.default_rng(1)
    params = JT.init_model(jax.random.PRNGKey(3), unrolled)
    state = {"params": params, "opt": jax.tree.map(
        lambda x: jnp.asarray(fill.random(x.shape), x.dtype),
        JOPT.init_opt(params, factored))}
    JaxCheckpointManager(str(path / "ckpt_unrolled")).save(
        3, state, blocking=True, extra_meta={"step": 3})
    inputs = {
        "g1": rng.standard_normal((8, 64)).astype(np.float32),
        "g2": rng.standard_normal((8, 64)).astype(np.float32),
        "tokens": rng.integers(0, 256, (8, 16), dtype=np.int32),
        "train_tok": rng.integers(0, 256, (2, 8, 16), dtype=np.int32),
        "train_lab": rng.integers(0, 256, (2, 8, 16), dtype=np.int32),
        "hybrid_cfg": _cfg_json(hybrid), "padded_cfg": _cfg_json(padded),
        "elastic_cfg": _cfg_json(elastic), "opt_cfg": json.dumps(TRAIN_OPT),
        "unrolled_cfg": _cfg_json(unrolled)}
    for name, tree in trees.items():
        inputs.update({f"{name}/{_key(k)}": v for k, v in _flat(tree).items()})
    np.savez(path / "in8.npz", **inputs)
    return {"inputs": inputs, "trees": trees, "cfgs": (hybrid, padded),
            "factored": factored, "unrolled_state": state}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The two worlds, started together when the module starts, so they
    run while the in-process tests do."""
    p8 = tmp_path_factory.mktemp("world8")
    w8 = _world8_inputs(p8)
    p4 = tmp_path_factory.mktemp("world4")
    key = jax.random.PRNGKey(0)
    Ws = np.asarray(jax.random.normal(key, (4, 16, 16)) * 0.3)
    x = np.asarray(jax.random.normal(key, (6, 8, 16)))
    from repro_torch.launch.mesh import free_port
    np.savez(p4 / "in4.npz", Ws=Ws, x=x, port2=free_port(),
             argv=np.array(LAUNCH_ARGV))
    started = {"world8": _ranks(p8, "world8", 8),
               "world4": _ranks(p4, "world4", 4)}
    yield {**started, "w8": w8, "p8": p8, "Ws": Ws, "x": x}
    for run in started.values():
        run.kill()


# ------------------------------------------------ pure specs, in-process

ARCH_IDS = sorted(jreg.ARCHS)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_cache_and_input_specs_equal_jax(arch):
    for scan in (True, False):
        jc = jreg.get_config(arch).replace(scan_layers=scan)
        tc = treg.get_config(arch).replace(scan_layers=scan)
        for mesh in MESHES:
            assert _jspec(JSH.param_specs(_Mesh(mesh), jc)) == \
                TSH.param_specs(mesh, tc), (scan, mesh)
            for batch in (128, 32, 1):
                assert _jspec(JSH.cache_specs(_Mesh(mesh), jc, batch)) == \
                    TSH.cache_specs(mesh, tc, batch), (scan, mesh, batch)
                assert tuple(P(JSH.batch_axes(_Mesh(mesh), batch), None)) \
                    == TSH.input_sharding(mesh, batch)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_specs_equal_jax(arch, monkeypatch):
    """``sharding.opt_specs`` (the Trainer's, ``reshard_state``'s and the
    dry-run's one tree) equals the JAX dry-run's ``opt_specs``, factored
    or not, scanned and unrolled."""
    # the JAX dry-run module sets XLA_FLAGS when imported: keep it here
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    from repro.launch import dryrun as JDR
    from repro_torch.launch import dryrun as TDR
    assert TDR.opt_specs is TSH.opt_specs
    for scan in (True, False):
        jc = jreg.get_config(arch).replace(scan_layers=scan)
        tc = treg.get_config(arch).replace(scan_layers=scan)
        jstruct, tstruct = JSPEC.param_struct(jc), TSPEC.param_struct(tc)
        for mesh in MESHES:
            jp = JSH.param_specs(_Mesh(mesh), jc)
            tp = TSH.param_specs(mesh, tc)
            for factored in (False, True):
                want = JDR.opt_specs(jp, jstruct,
                                     JOPT.OptConfig(factored=factored))
                got = TSH.opt_specs(tp, tstruct,
                                    TOPT.OptConfig(factored=factored))
                assert _jspec(want) == got, (scan, mesh, factored)


def test_resolve_spec_drops_what_does_not_divide():
    cases = [((8, 6, 4, 16), ("batch", "seq", "heads", None)),
             ((6, 3, 16), ("batch", None, "ffn")),
             ((1, 12, 40, 64), ("batch", "seq", "heads", "head_dim")),
             ((32, 16, 8), ("batch", "residual_seq", "embed"))]
    rules = dict(JAX_AX.DEFAULT_RULES, residual_seq="model")
    for mesh in MESHES:
        for shape, logical in cases:
            for r in (None, rules):
                want = tuple(JAX_AX.resolve_spec(_Mesh(mesh), shape, logical,
                                                 r))
                assert AX.resolve_spec(mesh, shape, logical, r) == want


def test_choose_mesh_shape_equals_jax():
    for n in range(1, 513):
        for tp in (2, 16):
            for mp in (False, True):
                assert TEL.choose_mesh_shape(n, tp, mp) == \
                    JEL.choose_mesh_shape(n, tp, mp)


def test_shapes_and_applicable_equal_jax():
    assert list(tshapes.SHAPES) == list(jshapes.SHAPES)
    for name, s in jshapes.SHAPES.items():
        t = tshapes.SHAPES[name]
        assert (t.name, t.kind, t.seq, t.batch, t.subquadratic_only) == \
            (s.name, s.kind, s.seq, s.batch, s.subquadratic_only)
        for arch in ARCH_IDS:
            assert tshapes.applicable(t, treg.get_config(arch)) == \
                jshapes.applicable(s, jreg.get_config(arch))


def _structs(tree) -> dict:
    return {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in iter_paths(tree)}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_launch_specs_equal_jax_eval_shape(arch):
    jc, tc = jreg.get_config(arch), treg.get_config(arch)

    def jstructs(tree):
        return {p: (tuple(x.shape), str(x.dtype))
                for p, x in _flat_structs(tree).items()}
    for name in jshapes.SHAPES:
        assert _structs(TSPEC.input_specs(tc, tshapes.SHAPES[name])) == \
            jstructs(JSPEC.input_specs(jc, jshapes.SHAPES[name])), name
    assert _structs(TSPEC.param_struct(tc)) == \
        jstructs(JSPEC.param_struct(jc))
    for factored in (False, True):
        assert _structs(TSPEC.train_state_struct(
            tc, TOPT.OptConfig(factored=factored))) == jstructs(
            JSPEC.train_state_struct(jc, JOPT.OptConfig(factored=factored)))


def _flat_structs(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path)] = leaf
    return out


def test_int8_compression_bitwise_jax():
    rng = np.random.default_rng(3)
    grads = {"a": rng.standard_normal((16, 8)).astype(np.float32) * 3,
             "b": {"c": rng.standard_normal((40,)).astype(np.float32),
                   "z": np.zeros((4,), np.float32)}}
    x = grads["a"]
    q, s = TC.quantize_int8(torch.from_numpy(x))
    jq, js = JC.quantize_int8(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(TC.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    # ties of round-half-to-even: x / scale lands on k + 0.5 exactly
    half = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    np.testing.assert_array_equal(
        TC.quantize_int8(torch.from_numpy(half))[0].numpy(),
        np.asarray(JC.quantize_int8(jnp.asarray(half))[0]))
    tg = {"a": torch.from_numpy(grads["a"]),
          "b": {"c": torch.from_numpy(grads["b"]["c"]),
                "z": torch.from_numpy(grads["b"]["z"])}}
    e = None
    je = None
    for _ in range(2):
        tq, ts, e = TC.compress_tree(tg, e)
        jq, js, je = JC.compress_tree(jax.tree.map(jnp.asarray, grads), je)
        for (p, a), b in zip(iter_paths(tq), jax.tree.leaves(jq)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for (p, a), b in zip(iter_paths(ts), jax.tree.leaves(js)):
            assert float(a) == float(b), p
        for (p, a), b in zip(iter_paths(e), jax.tree.leaves(je)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ------------------------------------------------------------ dry-run

def test_dryrun_counts_flops_per_device():
    """A one-layer MLP over a 2x2 fake mesh: each device does a quarter
    of the matmul flops (batch over data, ffn over model)."""
    import torch.distributed as dist
    import torch.nn.functional as F
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import analysis as AN
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh
    B, d, Fd = 64, 128, 512
    DR.fake_world(4)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        with FakeTensorMode():
            meta = {"x": torch.empty((B, d), device="meta"),
                    "up": torch.empty((d, Fd), device="meta"),
                    "down": torch.empty((Fd, d), device="meta")}
            specs = {"x": ("data", None), "up": ("data", "model"),
                     "down": ("model", "data")}
            t = DR.place(meta, specs, mesh)
            with AX.use_mesh(mesh), AN.CostMode() as mode:
                h = AX.hint(F.silu(t["x"] @ t["up"]), "batch", "ffn")
                AX.hint(h @ t["down"], "batch", "embed")
    finally:
        dist.destroy_process_group()
    assert mode.flops == (2 * B * d * Fd * 2) // 4
    assert AN.collective_bytes(mode)["total"] > 0


def test_analysis_helpers_equal_jax():
    """``extrapolate`` is JAX's; ``roofline_terms`` is JAX's over the
    H100's data-sheet peaks (each term one second at its peak)."""
    from repro.launch import analysis as JAN
    from repro_torch.launch import analysis as AN
    c1 = {"flops": 10.0, "collective_bytes": 3.0, "nested": {"x": 1.0}}
    c2 = {"flops": 14.0, "collective_bytes": 5.0, "nested": {"x": 1.5}}
    for n in (1, 2, 5, 48):
        assert AN.extrapolate(c1, c2, n) == JAN.extrapolate(c1, c2, n)
    hw = AN.H100_SXM
    t = AN.roofline_terms(hw["peak_flops_bf16"], hw["hbm_bw"],
                          hw["link_bw"], 256)
    assert (t["compute_s"], t["memory_s"], t["collective_s"]) == (1, 1, 1)
    jhw = {"peak_flops_bf16": hw["peak_flops_bf16"],
           "hbm_bw": hw["hbm_bw"], "ici_bw": hw["link_bw"]}
    for flops, nbytes, coll in ((1e15, 1e9, 1e6), (1.0, 1e13, 1.0),
                                (1.0, 1.0, 5e11)):
        got = AN.roofline_terms(flops, nbytes, coll, 256)
        want = JAN.roofline_terms(flops, nbytes, coll, 256, hw=jhw)
        assert got == want


@pytest.mark.parametrize("kernel", KERNEL_OPS)
def test_kernel_op_refuses_a_dtensor_on_the_cpu(kernel):
    """No DTensor reaches a kernel: each op's shared input check refuses
    one, naming local_map, on either device."""
    import torch.distributed as dist
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_mesh
    DR.fake_world(1)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cpu")
        assert check_op_refuses_dtensor(torch.device("cpu"), kernel,
                                        mesh) == {}
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ the 8-rank world

@pytest.fixture(scope="module")
def world8(runs):
    f32 = jnp.float32
    w8 = runs["w8"]
    inputs, (hybrid, padded) = w8["inputs"], w8["cfgs"]
    hp, pp = w8["trees"]["hybrid"], w8["trees"]["padded"]
    g1, g2, tokens = inputs["g1"], inputs["g2"], inputs["tokens"]
    train_tok, train_lab = inputs["train_tok"], inputs["train_lab"]
    path = runs["p8"]

    # the JAX references, while the ranks run
    ref = {}

    def psum_two(g1, g2):
        red1, e1 = JC.compressed_psum({"g": g1}, "pod")
        red2, e2 = JC.compressed_psum({"g": g2}, "pod", e1)
        return red1["g"], red2["g"], e1["g"], e2["g"]
    red1, red2, e1, e2 = jax.vmap(psum_two, axis_name="pod")(g1, g2)
    ref.update(red1=np.asarray(red1[0]), red2=np.asarray(red2[0]),
               e1=np.asarray(e1), e2=np.asarray(e2))
    ref["fwd"] = np.asarray(JT.forward(hp, hybrid, jnp.asarray(tokens),
                                       compute_dtype=f32)[0])
    cache = JT.init_cache(hybrid, 8, 32, dtype=f32)
    ref["dec"] = np.asarray(jax_make_serve_step(hybrid, compute_dtype=f32)(
        hp, cache, jnp.asarray(tokens[:, :1]), jnp.int32(0))[0])
    ref["padded"] = np.asarray(JT.forward(pp, padded, jnp.asarray(tokens),
                                          compute_dtype=f32)[0])
    ocfg = JOPT.OptConfig(**TRAIN_OPT)
    state = {"params": hp, "opt": JOPT.init_opt(hp, ocfg)}
    jstep = jax.jit(jax_make_train_step(hybrid, ocfg, compute_dtype=f32))
    losses = []
    for i in range(2):
        state, m = jstep(state, jnp.asarray(train_tok[i]),
                         jnp.asarray(train_lab[i]))
        losses.append(float(m["loss"]))
    ref["losses"] = losses
    ref["trained"] = _flat(state["params"])
    # the factored Trainer's two steps, from the state it restored
    fcfg = w8["factored"]
    state = {"params": hp, "opt": JOPT.init_opt(hp, fcfg)}
    fstep = jax.jit(jax_make_train_step(hybrid, fcfg, compute_dtype=f32))
    losses = []
    for i in range(2):
        state, m = fstep(state, jnp.asarray(train_tok[i]),
                         jnp.asarray(train_lab[i]))
        losses.append(float(m["loss"]))
    ref["factored_losses"] = losses
    ref["factored"] = {"params": _flat(state["params"]),
                       "m": _flat(state["opt"]["m"]),
                       "v": _flat(state["opt"]["v"])}
    # every gradient leaf on the first training batch
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jax_make_loss_fn(hybrid, f32), has_aux=True))(
        hp, jnp.asarray(train_tok[0]), jnp.asarray(train_lab[0]))
    ref["grad_loss"], ref["grads"] = float(loss), _flat(grads)
    res = runs["world8"].json()
    with np.load(path / "out8.npz") as f:
        out = {k: f[k] for k in f.files}
    return {"res": res, "out": out, "ref": ref, "path": path,
            "ref_trees": {**w8["trees"],
                          "unrolled_state": w8["unrolled_state"]}}


def test_tuple_axis_splits_pod_major(world8):
    """A dim sharded over ('pod', 'data') is split pod-major, as JAX
    splits P(('pod', 'data')) on the same mesh."""
    assert world8["res"]["tuple_order"]


def test_compressed_all_reduce_bitwise_jax(world8):
    out, ref = world8["out"], world8["ref"]
    for k in ("red1", "red2", "e1", "e2"):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert np.abs(ref["e1"]).max() > 0          # a residual is carried


def test_sharded_forward_matches_jax(world8):
    got, want = world8["out"]["fwd"], world8["ref"]["fwd"]
    assert got.shape == (8, 16, 256)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)


def test_sharded_decode_matches_jax(world8):
    got, want = world8["out"]["dec"], world8["ref"]["dec"]
    assert got.shape == (8, 256)
    np.testing.assert_allclose(got, want, atol=FWD_ATOL, rtol=0)
    # the state cache: batch over (pod, data), ssd heads over model
    assert world8["res"]["cache_placements"] == \
        "(Shard(dim=0), Shard(dim=0), Shard(dim=1))"


def test_padded_heads_forward_matches_jax(world8):
    """n_q 6, n_kv 2 on a model axis of 4: kv expanded to full heads and
    heads zero-padded to 8."""
    np.testing.assert_allclose(world8["out"]["padded"],
                               world8["ref"]["padded"], atol=FWD_ATOL,
                               rtol=0)


def _unrolled(scanned: dict) -> dict:
    """A JAX scanned tree's {path: array} keyed by the port's unrolled
    paths (slot ``j``, period ``t`` -> layer ``t * P + j``)."""
    n, P = _hybrid().n_periods, len(_hybrid().pattern)
    out = {}
    for path, arr in scanned.items():
        if path[0] == "blocks":
            for t in range(n):
                out[("blocks", t * P + path[1]) + path[2:]] = arr[t]
        else:
            out[path] = arr
    return out


def _got(out: dict, prefix: str) -> dict:
    """The rank program's arrays under ``prefix``, by path."""
    return {tuple(int(p) if p.isdigit() else p
                  for p in k[len(prefix):].split("/")): v
            for k, v in out.items() if k.startswith(prefix)}


def _rel_fro(got, want) -> float:
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def test_sharded_train_steps_match_jax(world8):
    res, ref, out = world8["res"], world8["ref"], world8["out"]
    np.testing.assert_allclose(res["losses"], ref["losses"], rtol=STEP_RTOL,
                               atol=0)
    want = _unrolled(ref["trained"])
    got = _got(out, "trained/")
    assert set(got) == set(want)
    for path, arr in want.items():
        err = np.linalg.norm(got[path] - arr) / np.linalg.norm(arr)
        assert err <= STEP_RTOL, (path, err)


def test_sharded_gradients_match_jax_leaf_by_leaf(world8):
    """Every gradient leaf of the sharded loss, gathered, within the
    unsharded port's GRAD_RTOL of JAX's ``value_and_grad``: attention,
    MLP, MoE and Mamba leaves."""
    np.testing.assert_allclose(world8["res"]["grad_loss"],
                               world8["ref"]["grad_loss"], rtol=STEP_RTOL,
                               atol=0)
    want = _unrolled(world8["ref"]["grads"])
    got = _got(world8["out"], "grad/")
    assert set(got) == set(want)
    kinds = {k for path in got for k in ("attn", "mlp", "moe", "mamba")
             if k in path}
    assert kinds == {"attn", "mlp", "moe", "mamba"}
    for path, arr in want.items():
        assert got[path].shape == arr.shape, path
        err = _rel_fro(got[path], arr)
        assert err <= GRAD_RTOL, (path, err)


def test_factored_trainer_on_mesh_matches_jax(world8):
    """The Trainer with a factored second moment on the 2x2x2 mesh,
    started from a JAX checkpoint: two steps within STEP_RTOL of JAX's
    in loss and in every leaf of params, m and v (row, col, full), with
    v laid out by the shared spec tree."""
    res, ref, out = world8["res"], world8["ref"], world8["out"]
    assert res["factored_start"] == 0 and res["factored_restored"]
    np.testing.assert_allclose(res["factored_losses"],
                               ref["factored_losses"], rtol=STEP_RTOL,
                               atol=0)
    wants = {"params": _unrolled(ref["factored"]["params"]),
             "m": _unrolled(ref["factored"]["m"]),
             "v": ref["factored"]["v"]}      # v keeps the scanned layout
    for name, want in wants.items():
        got = _got(out, f"factored/{name}/")
        assert set(got) == set(want), name
        for path, arr in want.items():
            err = _rel_fro(got[path], arr)
            assert err <= STEP_RTOL, (name, path, err)
    assert {k for path in wants["v"] for k in path[-1:]} == \
        {"row", "col", "full"}
    assert res["factored_v_placed"]
    assert res["factored_v_sharded"]["row"] > 0
    assert res["factored_v_sharded"]["col"] > 0


def test_factored_trainer_checkpoint_restores_bitwise_in_jax(world8):
    """The factored Trainer's save (JAX's scanned layout) restores in
    JAX bitwise equal to the state it gathered."""
    hp = world8["ref_trees"]["hybrid"]
    fcfg = JOPT.OptConfig(**TRAIN_OPT, factored=True)
    like = {"params": hp, "opt": JOPT.init_opt(hp, fcfg)}
    got = _flat(JaxCheckpointManager(str(world8["path"] / "ckpt_factored"))
                .restore(like))
    out = world8["out"]
    n, P = _hybrid().n_periods, len(_hybrid().pattern)
    assert int(got[("opt", "step")]) == 2
    for path, arr in got.items():
        if path == ("opt", "step"):
            continue
        name = path[0] if path[0] == "params" else path[1]
        rest = path[1:] if path[0] == "params" else path[2:]
        if name != "v" and rest[0] == "blocks":    # stack the layers
            want = np.stack([out[f"factored/{name}/" + _key(
                ("blocks", t * P + rest[1]) + rest[2:])] for t in range(n)])
        else:
            want = out[f"factored/{name}/" + _key(rest)]
        np.testing.assert_array_equal(arr, want, err_msg=str(path))


def test_sharded_checkpoint_restores_bitwise_in_jax(world8):
    run = _hybrid(scan=False)
    like = {"params": JT.init_model(jax.random.PRNGKey(0), run)}
    got = _flat(JaxCheckpointManager(str(world8["path"] / "ckpt_port"))
                .restore(like))
    trained = {k: v for k, v in world8["out"].items()
               if k.startswith("trained/")}
    assert len(got) == len(trained)
    for path, arr in got.items():
        np.testing.assert_array_equal(
            arr, trained["trained/" + _key(path[1:])])


def test_jax_factored_checkpoint_restores_bitwise_onto_mesh(world8):
    """An unrolled JAX state with a factored v (moments not zero)
    restored by the Trainer onto the 2x2x2 mesh: every leaf bitwise,
    v laid out by the shared spec tree."""
    res = world8["res"]
    assert res["unrolled_start"] == 3 and res["unrolled_v_placed"]
    want = _flat(world8["ref_trees"]["unrolled_state"])
    got = _got(world8["out"], "restored/")
    assert set(got) == set(want)
    assert any(path[-1] == "row" for path in got)
    for path, arr in want.items():
        np.testing.assert_array_equal(got[path], arr, err_msg=str(path))


def test_jax_checkpoint_restores_bitwise_onto_elastic_mesh(world8):
    res = world8["res"]
    assert res["elastic_shape"] == list(JEL.choose_mesh_shape(8, 2))
    assert res["elastic_bitwise"]
    assert res["elastic_sharded_leaves"] > 0


# ------------------------------------------------ the 4-rank world

@pytest.fixture(scope="module")
def world4(runs):
    Ws = runs["Ws"]

    def seq(x1):
        for i in range(4):
            x1 = jnp.tanh(x1 @ Ws[i])
        return x1
    ref = np.asarray(jax.vmap(seq)(jnp.asarray(runs["x"])))
    buf = io.StringIO()
    with redirect_stdout(buf):
        train_launch.main(LAUNCH_ARGV)
    return {"res": runs["world4"].json(), "ref": ref,
            "launch": buf.getvalue()}


def test_pipeline_matches_sequential(world4):
    got = np.asarray(world4["res"]["pipeline"], dtype=np.float32)
    assert got.shape == (6, 8, 16)
    np.testing.assert_allclose(got, world4["ref"], atol=PIPE_ATOL, rtol=0)


def _losses(text: str) -> list:
    return [float(line.split()[3]) for line in text.splitlines()
            if line.startswith("step ")]


def test_train_launcher_host_mesh_matches_one_process(world4):
    """``launch/train.py --mesh host`` on 2 gloo ranks prints the loss
    lines of the unsharded run."""
    sharded, plain = world4["res"]["launch"], world4["launch"]
    assert "done: 20 steps" in sharded
    assert len(_losses(sharded)) == 2
    np.testing.assert_allclose(_losses(sharded), _losses(plain), rtol=1e-5,
                               atol=0)


# ------------------------------------------------ the dry-run cell

def _jax_state_bytes(cfg, mesh: dict, batch: int, s_max: int) -> int:
    """Per-device bytes of bf16 params and a bf16 cache, from JAX's
    specs and eval_shape structs on a stub mesh of ``mesh``."""
    stub = _Mesh(mesh)

    def local(tree, specs):
        total = 0
        for leaf, spec in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs, is_leaf=lambda x: isinstance(x, P))):
            n = leaf.dtype.itemsize
            for dim, axis in zip(leaf.shape, tuple(spec) + (None,) * 8):
                n *= dim // AX.mesh_size(mesh, axis)
            total += n
        return total
    return (local(JSPEC.param_struct(cfg, jnp.bfloat16),
                  JSH.param_specs(stub, cfg))
            + local(JSPEC.cache_specs_struct(cfg, batch, s_max),
                    JSH.cache_specs(stub, cfg, batch)))


def test_dryrun_cell_passes_with_jax_state_bytes(runs, tmp_path):
    """JAX's own dry-run cell (mamba2-1.3b, decode_32k, 16x16), which
    JAX's test cannot compile here, within 60 s (after the worlds: it
    runs alone)."""
    for run in (runs["world8"], runs["world4"]):
        run.proc.wait(timeout=600)
    out, _, seconds = _Run([
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
        "mamba2-1.3b", "--shape", "decode_32k", "--no-cost-periods",
        "--out", str(tmp_path)], tmp_path).finish(timeout=60)
    assert seconds <= 60
    assert "ALL DRY-RUN CELLS COMPILED" in out
    with open(tmp_path / "mamba2-1.3b__decode_32k__single.json") as f:
        res = json.load(f)
    mem = res["memory"]
    cfg = jreg.get_config("mamba2-1.3b")
    shape = jshapes.SHAPES["decode_32k"]
    assert mem["params_bytes"] + mem["cache_bytes"] == _jax_state_bytes(
        cfg, {"data": 16, "model": 16}, shape.batch, shape.seq)
    assert res["cost"]["flops"] > 0
    assert res["collectives_raw"]["total"] > 0
