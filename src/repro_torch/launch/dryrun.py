"""Multi-pod dry-run driver, on a fake process group in one process.

For every (architecture x input shape) cell: build the step function
(train step, prefill step or serve step) over the production mesh
(16x16, or 2x16x16 with ``--multi-pod``), with every parameter, cache
and input a DTensor over fake local shards (``FakeTensorMode``: shapes
and dtypes, nothing allocated), run it once as rank 0 of a fake world of
256 or 512 ranks, and record the per-device state bytes, flops, bytes
and collective bytes (``launch/analysis.py``). A host tool, as the JAX
package's is: it runs on the CPU.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-72b --shape train_4k
  python -m repro_torch.launch.dryrun --all --out results/dryrun
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_map
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.distributed import axes as AX
from repro_torch.distributed import sharding as SH
from repro_torch.launch import analysis as AN
from repro_torch.launch import specs as SPEC
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.specs import ModelConfig
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import (make_loss_fn, make_train_step,
                                          value_and_grad)

ASSIGNED = [k for k in ARCHS if k != "llama3-8b"]

# Per-(arch, shape) resource knobs, the JAX package's. microbatches <=
# global_batch / dp_size (16) so every microbatch still shards over the
# data axis; seq_shard = Megatron-style sequence-parallel residual
# stream.
DEFAULTS = {"microbatches": 16, "factored": False, "m_dtype": "float32",
            "seq_shard": False, "accum_dtype": "float32"}
OVERRIDES = {
    ("nemotron-4-340b", "train_4k"): {
        "factored": True, "m_dtype": "bfloat16", "seq_shard": True,
        "accum_dtype": "bfloat16"},
    ("qwen2-72b", "train_4k"): {"seq_shard": True},
    ("llama4-scout-17b-16e", "train_4k"): {"seq_shard": True},
    ("jamba-v0.1-52b", "train_4k"): {"seq_shard": True},
}


def knobs(arch: str, shape: str) -> dict:
    out = dict(DEFAULTS)
    out.update(OVERRIDES.get((arch, shape), {}))
    return out


# ------------------------------------------------------------ the world

def fake_world(n_ranks: int) -> None:
    """This process as rank 0 of a fake world of ``n_ranks`` (no
    communication happens; collectives return uninitialised buffers).
    The fake process group lives in ``torch.testing._internal``: the one
    place this port imports it."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n_ranks:
            return
        dist.destroy_process_group()
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:            # a torch built without it
        raise RuntimeError(
            "the dry-run needs torch's fake process group "
            "(torch.testing._internal.distributed.fake_pg), which this "
            "torch does not have") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)


# ------------------------------------------------------------ shardings

def _drop_axis(spec: tuple, axis_from_end: int) -> tuple:
    parts = list(spec)
    if len(parts) >= axis_from_end:
        del parts[len(parts) - axis_from_end]
    return tuple(parts)


def opt_specs(pspec_tree, param_struct, opt_cfg: OPT.OptConfig) -> dict:
    """Spec tree of the optimizer state, mirroring the params'."""
    v = pspec_tree
    if opt_cfg.factored:
        def v_spec(leaf, spec):
            if leaf.dim() >= 2 and leaf.shape[-1] >= 2 \
                    and leaf.shape[-2] >= 2:
                return {"row": _drop_axis(spec, 1),
                        "col": _drop_axis(spec, 2)}
            return {"full": spec}
        v = SH.map_tree_specs(v_spec, param_struct, pspec_tree)
    return {"m": pspec_tree, "v": v, "step": ()}


def fake_dtensor(x: torch.Tensor, mesh, spec: tuple):
    """A DTensor of ``x``'s global shape and dtype laid out by ``spec``,
    over a fake local shard (call under ``FakeTensorMode``)."""
    from torch.distributed.tensor import DTensor
    local = list(x.shape)
    for d, axis in enumerate(spec):
        local[d] //= AX.mesh_size(mesh, axis)
    shard = torch.empty(local, dtype=x.dtype)
    stride = torch.empty(x.shape, device="meta").stride()
    return DTensor.from_local(shard, mesh, AX.spec_placements(mesh, spec),
                              run_check=False, shape=x.shape, stride=stride)


def place(tree, specs, mesh):
    return SH.map_tree_specs(lambda x, s: fake_dtensor(x, mesh, s), tree,
                             specs)


# ------------------------------------------------------------ builders

def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, kn: dict):
    """Returns ``(fn, args, state)``: the step function, its arguments
    (DTensors over fake shards; call under ``FakeTensorMode``) and the
    state trees whose local shards a device holds."""
    run = cfg.unrolled() if cfg.scan_layers else cfg
    pspecs = SH.param_specs(mesh, run)
    bspec = SH.input_sharding(mesh, shape.batch)
    ins = SPEC.input_specs(run, shape)

    def batch_input(name):
        x = ins[name]
        return fake_dtensor(x, mesh, (bspec + (None,) * x.dim())[:x.dim()])

    if shape.kind == "train":
        opt_cfg = OPT.OptConfig(factored=kn["factored"], m_dtype=kn["m_dtype"])
        struct = SPEC.train_state_struct(run, opt_cfg)
        params = place(struct["params"], pspecs, mesh)
        extra = ((batch_input("frontend_embeds"),)
                 if "frontend_embeds" in ins else ())
        if kn.get("skip_opt"):
            # grad-only variant (cost measurement): one microbatch
            grad_fn = value_and_grad(make_loss_fn(
                run, mesh=mesh, param_specs=pspecs))
            args = (params, batch_input("tokens"), batch_input("labels"),
                    *extra)
            return grad_fn, args, {"params": params}
        opt = place(struct["opt"],
                    opt_specs(pspecs, struct["params"], opt_cfg), mesh)
        state = {"params": params, "opt": opt}
        fn = make_train_step(run, opt_cfg, n_microbatches=kn["microbatches"],
                             mesh=mesh, batch_spec=bspec,
                             accum_dtype=getattr(torch, kn["accum_dtype"]),
                             param_specs=pspecs)
        args = (state, batch_input("tokens"), batch_input("labels"), *extra)
        return fn, args, {"params": params, "opt": opt}

    params = place(SPEC.param_struct(run, dtype=torch.bfloat16), pspecs, mesh)
    cache = place(ins["cache"], SH.cache_specs(mesh, run, shape.batch), mesh)
    tokens = batch_input("tokens")
    if shape.kind == "prefill":
        fn0 = make_prefill_step(run)
        fe = (batch_input("frontend_embeds")
              if "frontend_embeds" in ins else None)

        def fn(params, tokens, cache):
            return fn0(params, tokens, cache, frontend_embeds=fe)
        return fn, (params, tokens, cache), {"params": params,
                                             "cache": cache}
    fn = make_serve_step(run)
    return fn, (params, cache, tokens, 0), {"params": params, "cache": cache}


# ------------------------------------------------------------ the run

def trace_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, kn: dict):
    """Build the cell and run its step once as one rank. Returns
    ``(cost mode, seconds, state bytes)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    rules = dict(AX.DEFAULT_RULES)
    if kn.get("seq_shard"):
        rules["residual_seq"] = "model"
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args, state = build_cell(cfg, shape, mesh, kn)
        grad = contextlib.nullcontext() if shape.kind == "train" \
            else torch.no_grad()
        with grad:
            with AX.use_mesh(mesh, rules), AN.CostMode() as mode:
                fn(*args)
        memory = AN.memory_summary(state, mode)
    return mode, time.perf_counter() - t0, memory


def _cost_of(mode: AN.CostMode) -> dict:
    return {**AN.cost_summary(mode),
            "collective_bytes": AN.collective_bytes(mode)["total"]}


def measure_cost(cfg: ModelConfig, shape: ShapeSpec, mesh, kn: dict) -> dict:
    """Per-step cost terms from depth-1 and depth-2 runs (cost is affine
    in depth), with a single microbatch for train, recomposed:
        train:  n_micro * [outside + P*layer] + optimizer update
        serve:  outside + P*layer
    """
    if shape.kind == "train":
        micro = max(1, shape.batch // kn["microbatches"])
        shape_m = ShapeSpec(shape.name, "train", shape.seq, micro)
        kn_m = {**kn, "microbatches": 1, "skip_opt": True}
    else:
        shape_m, kn_m = shape, kn
    costs = []
    for d in (1, 2):
        cfg_d = cfg.replace(n_periods=d, scan_layers=False)
        mode, _, _ = trace_cell(cfg_d, shape_m, mesh, kn_m)
        costs.append(_cost_of(mode))
    total = AN.extrapolate(costs[0], costs[1], cfg.n_periods)
    if shape.kind == "train":
        opt = measure_opt_cost(cfg, mesh, kn)
        total = {k: kn["microbatches"] * total[k] + opt.get(k, 0.0)
                 for k in total}
    return total


def measure_opt_cost(cfg: ModelConfig, mesh, kn: dict) -> dict:
    """Cost of the optimizer update alone (once a step)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    run = cfg.unrolled() if cfg.scan_layers else cfg
    opt_cfg = OPT.OptConfig(factored=kn["factored"], m_dtype=kn["m_dtype"])
    pspecs = SH.param_specs(mesh, run)
    with FakeTensorMode():
        struct = SPEC.train_state_struct(run, opt_cfg)
        params = place(struct["params"], pspecs, mesh)
        grads = place(tree_map(lambda x: x.float(), struct["params"]),
                      pspecs, mesh)
        opt = place(struct["opt"],
                    opt_specs(pspecs, struct["params"], opt_cfg), mesh)
        with AN.CostMode() as mode:
            OPT.apply_updates(params, grads, opt, opt_cfg)
    return _cost_of(mode)


def run_cell(arch: str, shape_name: str, multi_pod: bool = False,
             cost_periods: bool = True, verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if not applicable(shape, cfg):
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": "long_500k requires sub-quadratic context"}
    kn = knobs(arch, shape_name)
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    result = {"arch": arch, "shape": shape_name,
              "mesh": "2x16x16" if multi_pod else "16x16", "knobs": kn}
    mode, dt, memory = trace_cell(cfg, shape, mesh, kn)
    result["trace_seconds"] = dt
    result["memory"] = memory
    result["cost_raw"] = AN.cost_summary(mode)
    result["collectives_raw"] = AN.collective_bytes(mode)
    result["cost"] = (measure_cost(cfg, shape, mesh, kn) if cost_periods
                      else _cost_of(mode))
    if verbose:
        print(f"[{arch} x {shape_name} @ {result['mesh']}] "
              f"traced {dt:.1f}s  "
              f"state {memory['state_bytes'] / 2**30:.2f} GiB  "
              f"activations <= "
              f"{memory['peak_activation_bytes'] / 2**30:.2f} GiB  "
              f"flops {result['cost']['flops']:.3e}  "
              f"coll {result['cost']['collective_bytes']:.3e} B",
              flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-cost-periods", action="store_true")
    ap.add_argument("--out", default=None, help="directory for JSON results")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(arch, shape) for arch in ASSIGNED for shape in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    meshes = [False, True] if (args.both_meshes or args.all) \
        else [args.multi_pod]
    failures = []
    try:
        for arch, shape in cells:
            for mp in meshes:
                try:
                    res = run_cell(arch, shape, multi_pod=mp,
                                   cost_periods=not args.no_cost_periods
                                   and not mp)
                    if args.out:
                        os.makedirs(args.out, exist_ok=True)
                        tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
                        with open(os.path.join(args.out, tag + ".json"),
                                  "w") as f:
                            json.dump(res, f, indent=1)
                except Exception as e:                    # noqa: BLE001
                    traceback.print_exc()
                    failures.append((arch, shape, mp, repr(e)))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        raise SystemExit(1)
    print("\nALL DRY-RUN CELLS COMPILED.")


if __name__ == "__main__":
    main()
