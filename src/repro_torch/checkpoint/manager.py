"""Checkpoints of a param tree, in the JAX package's on-disk layout.

Layout: ``<dir>/step_<N>/arrays.npz`` + ``meta.json``, written to a tmp
dir and renamed, so a partly written checkpoint is never visible. The
npz keys are the leaves' paths joined by ``/`` (``blocks/0/attn/q``), as
the JAX package writes them, so a checkpoint saved by either package
restores in the other.

bf16 leaves travel as raw 2-byte records (numpy has no bfloat16 without
``ml_dtypes``): the JAX package writes them through ``np.savez`` as
``'<V2'``, which loads back as ``'|V2'``. The port reads any 2-byte void
leaf as ``uint16`` bits of a bfloat16, and writes bf16 leaves the same
way. Restore fills a tree of the shapes and dtypes it is given, so the
caller decides the structure (``core.artifact`` derives it from the
pruned config, as the JAX package does with ``eval_shape``).

A save copies every leaf to the host before it returns; with
``blocking=False`` a background thread then writes the files while the
caller goes on (training continues while IO happens). ``wait`` joins
that thread; the next save waits for it first.

A sharded tree (DTensor leaves) is saved the same way: every rank
gathers each leaf whole (``full_tensor``, a collective), and rank 0
writes the unsharded arrays. ``restore`` with ``shardings`` places each
leaf on a mesh by its spec, so a checkpoint written on any mesh, or by
either package, restores onto any other.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.common.tree import iter_paths, tree_get, tree_set
from repro_torch.distributed.axes import full


def _path_key(path) -> str:
    return "/".join(str(p) for p in path)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as numpy; bf16 as raw 2-byte records."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def from_numpy(a: np.ndarray, dtype: Optional[torch.dtype] = None,
               device=None) -> torch.Tensor:
    """A stored leaf as a tensor; a 2-byte void leaf is bf16 bits. The
    leaf moves to ``device`` in its stored dtype and is cast there (a
    bf16 leaf widened to f32 on the card crosses the bus at half the
    bytes)."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t.to(device=device).to(dtype or t.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self.save_seconds = 0.0

    # -------------------------------------------------------------- save

    def save(self, step: int, tree: Any, blocking: bool = True,
             extra_meta: Optional[dict] = None) -> None:
        """Copy every leaf to the host, then write the step: here, or on
        a background thread when ``blocking=False``. A CPU leaf is
        cloned for a background write, so an in-place update after the
        call does not reach the file. A DTensor leaf is gathered whole
        on every rank (so every rank calls ``save``), and only rank 0 of
        the process group writes."""
        def snapshot(leaf):
            gathered = full(leaf)
            if not blocking and gathered is leaf and leaf.device.type == "cpu":
                gathered = leaf.detach().clone()
            return to_numpy(gathered)
        host = {_path_key(p): snapshot(leaf) for p, leaf in iter_paths(tree)}
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        meta = {"step": step, "time": time.time(), **(extra_meta or {})}
        self.wait()
        if blocking:
            self._write(step, host, meta)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()

    def _write(self, step: int, host: dict, meta: dict) -> None:
        t0 = time.perf_counter()
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()
        self.save_seconds = time.perf_counter() - t0

    def wait(self) -> None:
        """Join the background write, if one is running."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # ----------------------------------------------------------- restore

    def all_steps(self) -> list:
        return sorted(int(name.split("_")[1])
                      for name in os.listdir(self.directory)
                      if name.startswith("step_")
                      and not name.endswith(".tmp"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None,
                device=None, shardings: Any = None) -> Any:
        """Fill a tree shaped like ``like`` from the checkpoint. Each
        leaf of ``like`` only needs ``.shape`` and ``.dtype`` (a meta
        tensor does); the stored array must have that shape, and is cast
        to that dtype on ``device``. ``shardings`` (a tree of
        ``sharding.NamedSharding`` over ``like``'s paths) places each
        leaf on its mesh by its spec, as a DTensor on the mesh's
        device."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}", "arrays.npz")
        tree = like
        with np.load(path) as data:
            for p, leaf in iter_paths(like):
                arr = data[_path_key(p)]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{_path_key(p)}: stored shape "
                                     f"{arr.shape}, expected "
                                     f"{tuple(leaf.shape)}")
                if shardings is None:
                    leaf = from_numpy(arr, leaf.dtype, device)
                else:
                    leaf = tree_get(shardings, p).place(
                        from_numpy(arr, leaf.dtype))
                tree = tree_set(tree, p, leaf)
        return tree

    def meta(self, step: Optional[int] = None) -> dict:
        if step is None:
            step = self.latest_step()
        with open(os.path.join(self.directory, f"step_{step:08d}",
                               "meta.json")) as f:
            return json.load(f)

    # ------------------------------------------------- sidecar documents
    # Bundles keep JSON documents and array files next to the weight
    # checkpoint; writes are atomic (tmp + rename) like the checkpoint.

    def save_json(self, name: str, obj: Any) -> None:
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(obj, f, indent=2)
        os.replace(tmp, path)

    def load_json(self, name: str) -> Any:
        with open(os.path.join(self.directory, name)) as f:
            return json.load(f)

    def save_arrays(self, name: str, arrays: dict) -> None:
        path = os.path.join(self.directory, name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)

    def load_arrays(self, name: str) -> dict:
        with np.load(os.path.join(self.directory, name)) as data:
            return {k: data[k] for k in data.files}

    def has(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.directory, name))
