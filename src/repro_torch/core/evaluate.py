"""Pruned-model quality evaluation as a reusable core stage.

Every sweep point needs its quality (Compresso-style: tracked per
configuration, never assumed), so perplexity and zero-shot next-token
accuracy are a core module and a registered pipeline stage
(``evaluate``). A recipe that lists ``evaluate`` gets ``ppl`` / ``acc``
in the artifact report next to ``bytes_after`` / ``flop_savings`` — the
raw material of the sweep Pareto table.

The accuracy analogue of the paper's 7-dataset mean is three held-out
"tasks": top-1, top-5, and top-1 on a shifted-start-distribution split.
The batches are drawn with numpy from the synthetic corpus, so the port
and the JAX package evaluate the same tokens. Forwards run in f32 on the
params' device; the logits never leave it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Optional

import numpy as np
import torch

from repro_torch.common.tree import tree_device
from repro_torch.core.registry import register_stage
from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig


def _logits(params, cfg: ModelConfig, tokens) -> torch.Tensor:
    tokens = torch.as_tensor(tokens, device=tree_device(params)).long()
    logits, _, _ = T.forward(params, cfg, tokens,
                             compute_dtype=torch.float32)
    return logits


@torch.no_grad()
def perplexity(params, cfg: ModelConfig, batches: Iterable) -> float:
    """exp(mean cross-entropy) over (tokens, labels) batches."""
    tot = 0.0
    n = 0
    for tokens, labels in batches:
        logits = _logits(params, cfg, tokens)
        labels = torch.as_tensor(labels, device=logits.device)
        tot += float(T.cross_entropy(logits, labels, cfg.vocab))
        n += 1
    return math.exp(tot / max(n, 1))


@torch.no_grad()
def topk_accuracy(params, cfg: ModelConfig, batches: Iterable,
                  k: int = 5) -> tuple:
    """(top-1 %, top-k %) next-token accuracy (mean of batch means). A
    label counts once however many of the top k it ties with."""
    top1 = topk = n = 0
    for tokens, labels in batches:
        logits = _logits(params, cfg, tokens)[..., :cfg.vocab]
        labels = torch.as_tensor(labels, device=logits.device).long()
        pred = torch.argmax(logits, dim=-1)
        top1 += float((pred == labels).float().mean())
        idx = torch.topk(logits, k, dim=-1).indices
        topk += float((idx == labels[..., None]).any(-1).float().mean())
        n += 1
    n = max(n, 1)
    return 100.0 * top1 / n, 100.0 * topk / n


def accuracy(params, cfg: ModelConfig, batches: Iterable,
             shifted_batches: Optional[Iterable] = None) -> float:
    """Mean zero-shot accuracy over the held-out "tasks": top-1, top-5,
    and (when provided) top-1 on the shifted-start split."""
    top1, top5 = topk_accuracy(params, cfg, batches)
    accs = [top1, top5]
    if shifted_batches is not None:
        accs.append(topk_accuracy(params, cfg, shifted_batches)[0])
    return float(np.mean(accs))


@dataclasses.dataclass(frozen=True)
class EvalSpec:
    """How to draw the synthetic held-out evaluation set. The start
    indices keep it disjoint from both training (batches 0..) and
    calibration (batches 10_000..)."""
    batch_size: int = 8
    seq_len: int = 64
    n_ppl: int = 6
    ppl_start: int = 5000
    n_acc: int = 4
    acc_start: int = 6000
    shift: int = 7              # start-distribution roll for the 3rd task
    seed: int = 0


def synthetic_eval_batches(vocab: int, spec: EvalSpec = EvalSpec()) -> dict:
    """Materialised held-out batches: {'ppl': [...], 'acc': [...],
    'shifted': [...]} of numpy (tokens, labels) pairs."""
    from repro_torch.data.pipeline import SyntheticCorpus
    c = SyntheticCorpus(vocab, seed=spec.seed)
    ppl = list(c.batches(spec.batch_size, spec.seq_len,
                         start=spec.ppl_start, n=spec.n_ppl))
    acc = list(c.batches(spec.batch_size, spec.seq_len,
                         start=spec.acc_start, n=spec.n_acc))
    c2 = SyntheticCorpus(vocab, seed=spec.seed)      # same chains
    c2.start_probs = np.roll(c2.start_probs, spec.shift)
    shifted = list(c2.batches(spec.batch_size, spec.seq_len,
                              start=spec.acc_start, n=spec.n_acc))
    return {"ppl": ppl, "acc": acc, "shifted": shifted}


def evaluate_quality(params, cfg: ModelConfig, batches: dict) -> dict:
    """The quality row every sweep point carries."""
    return {"ppl": perplexity(params, cfg, batches["ppl"]),
            "acc": accuracy(params, cfg, batches["acc"],
                            batches.get("shifted"))}


def default_eval_batches(cfg: ModelConfig, recipe) -> dict:
    """Small held-out set sized from the recipe's calibration spec —
    shared by the ``evaluate`` stage fallback and the sweep runner so an
    N-point sweep evaluates every point on identical data."""
    c = recipe.calibration
    spec = EvalSpec(batch_size=c.batch_size, seq_len=c.seq_len,
                    n_ppl=2, n_acc=2, seed=c.seed)
    return synthetic_eval_batches(cfg.vocab, spec)


@register_stage("evaluate")
def stage_evaluate(ctx) -> None:
    """Quality stage: ppl/acc of the (pruned) model in ctx, into the
    report. Works in any stage order — it updates ctx.report directly
    and stage_report also merges ctx.quality."""
    batches = ctx.eval_batches
    if batches is None:
        batches = default_eval_batches(ctx.cfg, ctx.recipe)
        ctx.eval_batches = batches
    ctx.quality = evaluate_quality(ctx.params, ctx.cfg, batches)
    ctx.report.update(ctx.quality)
