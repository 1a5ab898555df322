"""Elastic scaling: derive a mesh from whatever ranks are alive and
reshard state onto it.

Policy: keep the model axis as close to the target TP degree as the rank
count allows (TP must divide the model's shardable dims), grow and
shrink data parallelism with the fleet. Restores go through
``CheckpointManager.restore`` with the new mesh's shardings: checkpoints
store unsharded logical arrays, so no resharding-aware format is needed.
"""
from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from repro_torch.distributed.axes import full
from repro_torch.models.specs import ModelConfig


def choose_mesh_shape(n_devices: int, target_tp: int = 16,
                      multi_pod: bool = False) -> tuple:
    """(data, model) or (pod, data, model) sized to the live fleet."""
    tp = min(target_tp, n_devices)
    while n_devices % tp:
        tp //= 2
    dp = n_devices // tp
    if multi_pod and dp % 2 == 0 and dp > 1:
        return (2, dp // 2, tp)
    return (dp, tp)


def make_elastic_mesh(n_devices: Optional[int] = None, target_tp: int = 16,
                      multi_pod: bool = False, device_type=None):
    """A mesh over the first ``n_devices`` ranks of the world (all of
    them by default), shaped by ``choose_mesh_shape``. Every rank of the
    world calls it (the mesh's groups are made collectively); a rank past
    ``n_devices`` gets a mesh it is not in (``get_coordinate()`` None)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"{n} ranks asked for, the world has {world}")
    shape = choose_mesh_shape(n, target_tp, multi_pod)
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                              "model")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def reshard_state(state: dict, mesh, cfg: ModelConfig) -> dict:
    """Move a train state (plain tensors, or DTensors on another mesh)
    onto ``mesh`` by the standard sharding policy: params and the first
    moment by ``param_specs``, the second moment too unless it is
    factored (a factored ``v`` has another structure and is left where
    it is)."""
    from repro_torch.common.tree import tree_map
    from repro_torch.distributed import sharding as SH
    specs = SH.param_specs(mesh, cfg.unrolled() if cfg.scan_layers else cfg)

    def put(tree):
        tree = {**tree, "blocks": SH.unrolled_blocks(tree["blocks"], cfg)}
        return SH.shard_tree(tree_map(full, tree), specs, mesh)

    new_state = dict(state)
    new_state["params"] = put(state["params"])
    if "opt" in state:
        opt = dict(state["opt"])
        opt["m"] = put(opt["m"])
        try:
            opt["v"] = put(opt["v"])
        except (KeyError, TypeError):
            pass        # factored v: another structure, left as it is
        new_state["opt"] = opt
    return new_state
