"""Training launcher.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \
      --smoke --steps 50 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train \
      --arch qwen3-moe-30b-a3b --smoke --steps 200 \
      --ckpt-dir results/ckpt                          # on the card
  PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \
      --arch llama3-8b --smoke --steps 20 --mesh host --device cpu

Trains on the synthetic corpus with the port's ``Trainer``: f32 compute
with ``--smoke``, bf16 over f32 masters otherwise. With ``--ckpt-dir`` a
run resumes from the latest checkpoint there (either package's) and
continues the same data stream and schedule: ``--steps`` counts every
step of the run, the resumed ones included. Runs on ``--device cuda``
(the default) and raises when CUDA is missing, unless ``--device cpu``
is given.

``--mesh host`` shards the state over every rank of the world on a
(data, model) mesh (``launch/mesh.py::make_host_mesh``, model 2 where
the world size allows): run it under ``torchrun --nproc-per-node N``
(NCCL, one card a rank), with ``--device cpu`` on gloo ranks, or as one
process for a world of 1. Rank 0 prints and writes the checkpoints.
"""
from __future__ import annotations

import argparse
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import (get_config, get_smoke_config,
                                          list_archs)
from repro_torch.data.pipeline import SyntheticCorpus
from repro_torch.launch.mesh import init_distributed, make_host_mesh
from repro_torch.models.specs import ModelConfig
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import TrainReport, Trainer


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n\n")[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog="--mesh host shards the state over the ranks of the world:\n"
               "  torchrun --nproc-per-node N -m repro_torch.launch.train "
               "--mesh host\n"
               "(NCCL; --device cpu for gloo ranks), or one process for a "
               "world of 1.")
    ap.add_argument("--arch", choices=list_archs(), default="llama3-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, f32 compute (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100,
                    help="steps of the whole run, resumed ones included")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' to run "
                         "without a card)")
    ap.add_argument("--mesh", choices=["none", "host"], default="none",
                    help="'host': shard over the world's ranks")
    return ap


def _log(step: int, metrics: dict) -> None:
    if step % 10 == 0 and _is_rank0():
        print(f"step {step:5d}  loss {float(metrics['loss']):.4f}  "
              f"lr {float(metrics['lr']):.2e}", flush=True)


def _is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def make_trainer(args: argparse.Namespace,
                 cfg: Optional[ModelConfig] = None) -> tuple:
    """``(trainer, steps left)`` for parsed ``args``. ``cfg`` replaces
    the ``--arch`` lookup (a config built in code)."""
    if cfg is None:
        cfg = get_smoke_config(args.arch) if args.smoke \
            else get_config(args.arch)
        cfg = cfg.replace(scan_layers=cfg.scan_layers and not args.smoke)
    opt = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                    total_steps=args.steps)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = (ckpt.meta()["step"]
             if ckpt is not None and ckpt.latest_step() is not None else 0)
    corpus = SyntheticCorpus(cfg.vocab, seed=0)
    device, mesh = args.device, None
    if args.mesh == "host":
        device = init_distributed(args.device)
        mesh = make_host_mesh()
    trainer = Trainer(cfg, opt, corpus.batches(args.batch, args.seq,
                                               start=start),
                      ckpt=ckpt, ckpt_every=args.ckpt_every,
                      n_microbatches=args.microbatches,
                      compute_dtype=(torch.float32 if args.smoke
                                     else torch.bfloat16),
                      log_fn=_log, device=device, mesh=mesh)
    return trainer, args.steps - trainer.step


def main(argv=None, cfg: Optional[ModelConfig] = None) -> TrainReport:
    args = build_parser().parse_args(argv)
    owns_group = args.mesh == "host" and not dist.is_initialized()
    try:
        trainer, n_steps = make_trainer(args, cfg)
        try:
            report = trainer.run(n_steps)
        finally:
            trainer.preemption.uninstall()  # give SIGTERM back to the caller
        final = f"{report.losses[-1]:.4f}" if report.losses else "n/a"
        if _is_rank0():
            print(f"\ndone: {report.steps_run} steps, final loss {final}, "
                  f"stragglers flagged: {len(report.stragglers)}, "
                  f"preempted: {report.preempted}")
    finally:
        if owns_group and dist.is_initialized():
            dist.destroy_process_group()
    return report


if __name__ == "__main__":
    main()
