"""Shape-and-dtype stand-ins for every (arch x shape) dry-run cell.

No allocation: the leaves are ``meta`` tensors, the counterpart of the
JAX package's ``ShapeDtypeStruct``s, in the JAX package's layout (a
scanned config's blocks stacked per pattern slot).
"""
from __future__ import annotations

import torch

from repro_torch.common.interop import stack_blocks
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig
from repro_torch.train import optimizer as OPT


def sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def frontend_len(cfg: ModelConfig, seq: int) -> int:
    return int(cfg.frontend_frac * seq) if cfg.frontend else 0


def input_specs(cfg: ModelConfig, shape: ShapeSpec,
                cache_dtype=torch.bfloat16) -> dict:
    """The keyword arguments (as meta tensors) of the step function of
    this shape's kind."""
    B, S = shape.batch, shape.seq
    if shape.kind == "train":
        out = {"tokens": sds((B, S), torch.int32),
               "labels": sds((B, S), torch.int32)}
        F = frontend_len(cfg, S)
        if F:
            out["frontend_embeds"] = sds((B, F, cfg.d_model), torch.bfloat16)
        return out
    if shape.kind == "prefill":
        out = {"tokens": sds((B, S), torch.int32),
               "cache": cache_specs_struct(cfg, B, S, cache_dtype)}
        F = frontend_len(cfg, S)
        if F:
            out["frontend_embeds"] = sds((B, F, cfg.d_model), torch.bfloat16)
        return out
    if shape.kind == "decode":
        return {"cache": cache_specs_struct(cfg, B, S, cache_dtype),
                "tokens": sds((B, 1), torch.int32),
                "cache_index": sds((), torch.int32)}
    raise ValueError(shape.kind)


def _layout(cfg: ModelConfig, blocks: list):
    """Unrolled per-layer trees in ``cfg``'s layout (stacked if scanned)."""
    return stack_blocks(blocks, len(cfg.pattern)) if cfg.scan_layers \
        else blocks


def cache_specs_struct(cfg: ModelConfig, batch: int, s_max: int,
                       dtype=torch.bfloat16):
    run = cfg.unrolled() if cfg.scan_layers else cfg
    return _layout(cfg, T.init_cache(run, batch, s_max, dtype=dtype,
                                     device="meta"))


def param_struct(cfg: ModelConfig, dtype=torch.bfloat16) -> dict:
    run = cfg.unrolled() if cfg.scan_layers else cfg
    params = T.init_model(None, run, dtype=dtype)
    return {**params, "blocks": _layout(cfg, params["blocks"])}


def train_state_struct(cfg: ModelConfig, opt_cfg: OPT.OptConfig,
                       param_dtype=torch.float32) -> dict:
    params = param_struct(cfg, dtype=param_dtype)
    return {"params": params, "opt": OPT.init_opt(params, opt_cfg)}
