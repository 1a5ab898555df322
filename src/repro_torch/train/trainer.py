"""Training loop: data prefetch, checkpoint and restart, preemption
handling, straggler monitoring. The driver behind ``launch/train.py``.

Checkpoints hold ``{'params', 'opt'}`` in the JAX package's layout, so a
run started by either package resumes in the other. A scanned config
(``scan_layers=True``) trains unrolled here and is stacked back into
JAX's scanned layout at every save, and unstacked at restore
(``common/interop.py``).

With a ``mesh`` the state is sharded by ``distributed/sharding.py``'s
specs (params and both moments) and each batch is laid out by
``batch_spec``; every rank runs the loop on the same batches, and a
save gathers the state whole (rank 0 writes).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.common.device import resolve_device
from repro_torch.common.interop import stack_blocks, unstack_blocks
from repro_torch.common.tree import tree_map
from repro_torch.data.pipeline import Prefetcher
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.axes import full
from repro_torch.distributed.elastic import reshard_state
from repro_torch.distributed.fault import PreemptionHandler, StragglerMonitor
from repro_torch.models.specs import ModelConfig
from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import init_train_state, make_train_step


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_step: int
    losses: list
    step_seconds: list
    stragglers: list
    preempted: bool


def _with_blocks(tree: dict, blocks) -> dict:
    return {**tree, "blocks": blocks}


class Trainer:
    """Trains ``cfg`` from random params drawn from
    ``torch.Generator(seed)`` on ``device`` (``cuda`` unless the caller
    asks for another), or from the latest checkpoint in ``ckpt`` when
    there is one. ``data_it`` yields ``(tokens, labels)`` numpy or tensor
    pairs of shape (B, S). ``compute_dtype`` defaults to bf16 over f32
    master params. ``mesh`` (a ``DeviceMesh``) shards the state by the
    standard specs; ``batch_spec`` (default: the batch over the data
    axes) lays out each batch."""

    def __init__(self, cfg: ModelConfig, opt_cfg: OPT.OptConfig,
                 data_it: Iterator, ckpt: Optional[CheckpointManager] = None,
                 ckpt_every: int = 100, n_microbatches: int = 1,
                 compute_dtype=None, seed: int = 0,
                 log_fn: Optional[Callable] = None,
                 prefetch: bool = True, async_checkpoint: bool = True,
                 device=None, mesh=None, batch_spec=None):
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is not None and opt_cfg.factored:
            raise NotImplementedError("a factored second moment is not "
                                      "sharded by the Trainer")
        self.cfg = cfg
        self.run_cfg = cfg.unrolled() if cfg.scan_layers else cfg
        self.opt_cfg = opt_cfg
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.async_checkpoint = async_checkpoint
        self.log_fn = log_fn or (lambda *_: None)
        self.data = Prefetcher(data_it) if prefetch else data_it
        specs = (SH.param_specs(mesh, self.run_cfg) if mesh is not None
                 else None)
        self.train_step = make_train_step(
            self.run_cfg, opt_cfg, n_microbatches=n_microbatches,
            compute_dtype=compute_dtype or torch.bfloat16, mesh=mesh,
            batch_spec=batch_spec, param_specs=specs)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = self._on_mesh(init_train_state(gen, self.run_cfg,
                                                    opt_cfg))
        self.step = 0
        self.preemption = PreemptionHandler().install()
        self.straggler = StragglerMonitor()
        if ckpt is not None and ckpt.latest_step() is not None:
            self.state = self._restore()
            self.step = ckpt.meta()["step"]

    # ------------------------------------------------ checkpoint layout

    def _to_layout(self, state: dict, blocks_fn) -> dict:
        """``state`` with ``blocks_fn`` applied to the blocks of the
        params and of both moments."""
        opt = state["opt"]
        return {"params": _with_blocks(state["params"],
                                       blocks_fn(state["params"]["blocks"])),
                "opt": {**opt,
                        "m": _with_blocks(opt["m"],
                                          blocks_fn(opt["m"]["blocks"])),
                        "v": _with_blocks(opt["v"],
                                          blocks_fn(opt["v"]["blocks"]))}}

    def _on_mesh(self, state: dict) -> dict:
        """``state`` sharded onto the mesh, if there is one."""
        if self.mesh is None:
            return state
        return reshard_state(state, self.mesh, self.run_cfg)

    def _checkpoint_tree(self) -> dict:
        """The state in the on-disk layout: scanned configs stack the
        blocks on the host (JAX's layout), gathered whole when sharded;
        unrolled ones save as is."""
        if not self.cfg.scan_layers:
            return self.state
        P = len(self.cfg.pattern)
        return self._to_layout(self.state, lambda b: stack_blocks(
            tree_map(lambda x: full(x).detach().cpu(), b), P))

    def _restore(self) -> dict:
        meta = tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                              device="meta"), self.state)
        device = self.device if self.mesh is None else "cpu"
        if not self.cfg.scan_layers:
            return self._on_mesh(self.ckpt.restore(meta, device=device))
        P, n = len(self.cfg.pattern), self.cfg.n_periods
        like = self._to_layout(meta, lambda b: stack_blocks(b, P))
        stored = self.ckpt.restore(like, device=device)
        return self._on_mesh(
            self._to_layout(stored, lambda b: unstack_blocks(b, n)))

    # -------------------------------------------------------------- run

    def _batch(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def run(self, n_steps: int) -> TrainReport:
        """``n_steps`` more steps, or fewer when the data ends or a
        preemption is signalled (the state is saved first)."""
        losses, times = [], []
        preempted = False
        target = self.step + n_steps
        while self.step < target:
            try:
                tokens, labels = next(self.data)
            except StopIteration:
                break
            t0 = time.perf_counter()
            self.state, metrics = self.train_step(
                self.state, self._batch(tokens), self._batch(labels))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.step += 1
            losses.append(loss)
            times.append(dt)
            self.straggler.record(self.step, dt)
            self.log_fn(self.step, metrics)
            if self.ckpt and self.step % self.ckpt_every == 0:
                self._save()
            if self.preemption.should_stop:
                self._save()
                preempted = True
                break
        if self.ckpt:
            self._save()
            self.ckpt.wait()
        return TrainReport(steps_run=len(losses), final_step=self.step,
                           losses=losses, step_seconds=times,
                           stragglers=list(self.straggler.flagged),
                           preempted=preempted)

    def _save(self) -> None:
        if self.ckpt:
            self.ckpt.save(self.step, self._checkpoint_tree(),
                           blocking=not self.async_checkpoint,
                           extra_meta={"step": self.step})
