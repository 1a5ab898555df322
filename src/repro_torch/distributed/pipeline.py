"""Pipeline parallelism: the GPipe schedule over a 'stage' mesh dim.

Stages hold contiguous layer groups (params stacked on a leading stage
axis, stage ``s`` holding slice ``s``); microbatches ripple through the
ring, one stage down per tick, with point-to-point sends on the stage
dim's process group. Held against the unpipelined composition on CPU
ranks.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.common.tree import tree_map


def _stage_slice(p: torch.Tensor, stage: int) -> torch.Tensor:
    """This stage's params: the local shard of a DTensor sharded over the
    stage dim (leading axis 1), or slice ``stage`` of a whole stack."""
    if hasattr(p, "to_local"):
        return p.to_local()[0]
    return p[stage]


def pipeline_forward(stage_fn: Callable, stage_params, x_microbatches,
                     mesh, axis: str = "stage") -> torch.Tensor:
    """Run ``stage_fn(params_for_stage, x) -> x`` over a pipeline.

    stage_params: tree with a leading stage axis (DTensors sharded over
    ``axis``, or whole stacks on every rank). x_microbatches: (n_micro,
    mb, ...) inputs, the same on every rank. Returns the last stage's
    (n_micro, mb, ...) outputs on every rank. Ticks ``t`` in ``[0,
    n_micro + n_stages - 1)``: stage 0 feeds microbatch ``t`` (the last
    one again once they run out), every stage applies its layers and
    passes its output one stage down the ring, and the last stage
    commits microbatch ``t - n_stages + 1``.
    """
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n_stages = len(ranks)
    stage = mesh.get_local_rank(axis)
    n_micro = x_microbatches.shape[0]
    params = tree_map(lambda p: _stage_slice(p, stage), stage_params)
    nxt_rank = ranks[(stage + 1) % n_stages]
    prev_rank = ranks[(stage - 1) % n_stages]

    buf = torch.zeros_like(x_microbatches[0])
    outs = torch.zeros_like(x_microbatches)
    for t in range(n_micro + n_stages - 1):
        inp = x_microbatches[min(t, n_micro - 1)] if stage == 0 else buf
        out = stage_fn(params, inp).contiguous()
        commit = t - (n_stages - 1)
        if stage == n_stages - 1 and commit >= 0:
            outs[commit] = out
        if n_stages > 1:
            buf = torch.empty_like(out)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, out, nxt_rank, group),
                dist.P2POp(dist.irecv, buf, prev_rank, group)])
            for r in reqs:
                r.wait()
    dist.broadcast(outs, src=ranks[-1], group=group)
    return outs
