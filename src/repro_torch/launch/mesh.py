"""Process groups and device meshes.

Functions, not module-level constants, so importing this module touches
no process group. ``init_distributed`` reads torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); without it the world is this one process, on a free
port of 127.0.0.1.
"""
from __future__ import annotations

import os
import socket

import torch
import torch.distributed as dist

from repro_torch.common.device import resolve_device


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device=None) -> torch.device:
    """Join (or start) the default process group: NCCL on ``cuda`` (the
    default; raises when CUDA is missing), gloo on ``cpu``. Returns this
    rank's device (``cuda:LOCAL_RANK``). A no-op when the group exists."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    rank = int(os.environ.get("RANK", "0"))
    world = int(os.environ.get("WORLD_SIZE", "1"))
    addr = os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = os.environ.get("MASTER_PORT") or str(free_port())
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{port}", rank=rank,
                            world_size=world, **kw)
    return dev


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(shape: tuple, names: tuple, device_type=None):
    """A ``DeviceMesh`` of ``shape`` over the world's ranks in order."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(), tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device_type=None):
    """16x16 = 256 ranks per pod; ``multi_pod`` adds a 2-pod axis. Raises
    unless the world (a real one, or the dry-run's fake one) has that
    size."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() != n:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{n} ranks, not {dist.get_world_size()}")
    return make_mesh(shape, names, device_type)


def make_host_mesh(model: int = 2, device_type=None):
    """(data, model) over every rank of the world: ``model`` the largest
    divisor of the world size not above the request."""
    n = dist.get_world_size()
    model = max(1, min(model, n))
    while n % model:
        model -= 1
    return make_mesh((n // model, model), ("data", "model"), device_type)
