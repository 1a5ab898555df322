"""Structured projection pruning: physically remove attention heads,
feed-forward channels, MoE expert channels and SSD heads (Fig. 4).

Kept group counts stay multiples of a configurable alignment, so pruned
widths stay tile friendly. Scores are post-mask magnitudes by default —
heads hollowed out by unstructured pruning rank lowest, which is exactly
the paper's composite synergy. Whole-expert removal (``expert_frac``)
goes beyond the paper.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.registry import register_category
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MambaSpec,
                                      MLPSpec, ModelConfig, MoESpec)


def _aligned_keep(total: int, frac: float, align: int, min_keep: int) -> int:
    """Number of groups to keep: multiple of align, >= min_keep."""
    keep = total - int(round(frac * total))
    keep = max(min_keep, keep)
    if align > 1:
        keep = max(align, int(round(keep / align)) * align)
    return min(keep, total)


def _abs32(x: torch.Tensor) -> torch.Tensor:
    return x.float().abs()


# ---------------------------------------------------------------- attention

def prune_attention(block: dict, spec: AttentionSpec, frac: float,
                    align_heads: int) -> tuple:
    """Remove the lowest-magnitude q heads, equally per kv group."""
    attn = block["attn"]
    g = spec.n_q // spec.n_kv                      # q heads per kv group
    # score per q head: |q| + |o| mass
    hs = _abs32(attn["q"]).sum(dim=(0, 2)) + _abs32(attn["o"]).sum(dim=(1, 2))
    if "q_bias" in attn:
        hs = hs + _abs32(attn["q_bias"]).sum(-1)
    hs = hs.cpu().numpy().reshape(spec.n_kv, g)
    keep_per_group = _aligned_keep(
        g, frac, max(1, align_heads // spec.n_kv), 1)
    # keep total q heads multiple of align_heads when possible
    while (keep_per_group * spec.n_kv) % align_heads and keep_per_group < g:
        keep_per_group += 1
    kept = []
    for kv in range(spec.n_kv):
        order = np.argsort(-hs[kv])[:keep_per_group]
        kept.extend(sorted(kv * g + int(h) for h in order))
    kept = torch.as_tensor(kept, dtype=torch.long, device=attn["q"].device)

    new_attn = dict(attn)
    new_attn["q"] = attn["q"].index_select(1, kept)
    new_attn["o"] = attn["o"].index_select(0, kept)
    if "q_bias" in attn:
        new_attn["q_bias"] = attn["q_bias"].index_select(0, kept)
    new_block = dict(block)
    new_block["attn"] = new_attn
    new_spec = dataclasses.replace(spec, n_q=keep_per_group * spec.n_kv)
    return new_block, new_spec


# ---------------------------------------------------------------- mlp / moe

def prune_mlp(block: dict, spec: MLPSpec, frac: float,
              align_channels: int) -> tuple:
    mlp = block["mlp"]
    cs = _abs32(mlp["up"]).sum(0) + _abs32(mlp["down"]).sum(1)
    if spec.gated:
        cs = cs + _abs32(mlp["gate"]).sum(0)
    keep = _aligned_keep(spec.d_ff, frac, align_channels, align_channels)
    kept = torch.sort(torch.argsort(-cs, stable=True)[:keep]).values
    new_mlp = dict(mlp)
    new_mlp["up"] = mlp["up"].index_select(1, kept)
    new_mlp["down"] = mlp["down"].index_select(0, kept)
    if spec.gated:
        new_mlp["gate"] = mlp["gate"].index_select(1, kept)
    new_block = dict(block)
    new_block["mlp"] = new_mlp
    return new_block, dataclasses.replace(spec, d_ff=int(keep))


def prune_moe(block: dict, spec: MoESpec, frac: float,
              align_channels: int) -> tuple:
    """Remove the same number of hidden channels from every expert, each
    expert keeping its own highest-mass channels (in index order)."""
    moe = block["moe"]
    cs = _abs32(moe["up"]).sum(dim=1) + _abs32(moe["down"]).sum(dim=2)
    if spec.gated:                                        # (E, d_ff)
        cs = cs + _abs32(moe["gate"]).sum(dim=1)
    keep = _aligned_keep(spec.d_ff, frac, align_channels,
                         min(align_channels, spec.d_ff))
    kept = torch.sort(torch.argsort(-cs, dim=1, stable=True)[:, :keep],
                      dim=1).values                       # (E, keep)
    E = kept.shape[0]

    def take_out(w):          # (E, d, d_ff) -> (E, d, keep)
        return torch.gather(w, 2, kept[:, None, :].expand(E, w.shape[1],
                                                          keep))

    new_moe = dict(moe)
    new_moe["up"] = take_out(moe["up"])
    new_moe["down"] = torch.gather(                       # (E, keep, d)
        moe["down"], 1, kept[:, :, None].expand(E, keep,
                                                moe["down"].shape[2]))
    if spec.gated:
        new_moe["gate"] = take_out(moe["gate"])
    new_block = dict(block)
    new_block["moe"] = new_moe
    return new_block, dataclasses.replace(spec, d_ff=int(keep))


def prune_experts(block: dict, spec: MoESpec, frac: float) -> tuple:
    """Beyond-paper extension: remove whole experts (the coarsest MoE
    group). Experts are scored by routed mass proxy (router column norm)
    x weight mass; at least top_k experts are kept and the router is
    re-shaped accordingly. The ranking is numpy's ``argsort(-score)``,
    as in the JAX package, so ties keep the same experts."""
    moe = block["moe"]
    E = spec.n_experts
    router_mass = _abs32(moe["router"]).sum(dim=0)               # (E,)
    w_mass = (_abs32(moe["up"]).sum(dim=(1, 2))
              + _abs32(moe["down"]).sum(dim=(1, 2)))
    if spec.gated:
        w_mass = w_mass + _abs32(moe["gate"]).sum(dim=(1, 2))
    score = (router_mass * w_mass).cpu().numpy()
    keep = max(spec.top_k, E - int(round(frac * E)))
    kept = np.sort(np.argsort(-score)[:keep])
    kept_t = torch.as_tensor(kept, dtype=torch.long,
                             device=moe["router"].device)
    new_moe = dict(moe)
    new_moe["router"] = moe["router"].index_select(1, kept_t)
    for name in ("up", "down") + (("gate",) if spec.gated else ()):
        new_moe[name] = moe[name].index_select(0, kept_t)
    new_block = dict(block)
    new_block["moe"] = new_moe
    return new_block, dataclasses.replace(spec, n_experts=int(keep))


# ---------------------------------------------------------------- mamba

def prune_mamba(block: dict, spec: MambaSpec, frac: float,
                align_heads: int) -> tuple:
    """Remove whole SSD heads (head_dim-sized channel groups) from the
    ``in_proj`` columns ``[z, x, B, C, dt]``, the conv channels
    ``[x, B, C]``, the per-head leaves and the ``out_proj`` rows."""
    m = block["mamba"]
    di, P, H = spec.d_inner, spec.head_dim, spec.n_heads
    GN = spec.n_groups * spec.d_state
    w_in = _abs32(m["in_proj"])
    z_mass = w_in[:, :di].sum(0).reshape(H, P).sum(1)
    x_mass = w_in[:, di:2 * di].sum(0).reshape(H, P).sum(1)
    out_mass = _abs32(m["out_proj"]).sum(1).reshape(H, P).sum(1)
    hs = (z_mass + x_mass + out_mass).cpu().numpy()
    keep = _aligned_keep(H, frac, align_heads, align_heads)
    kept = np.sort(np.argsort(-hs)[:keep])

    ch = np.concatenate([np.arange(h * P, (h + 1) * P) for h in kept])
    cols = np.concatenate([ch, di + ch, np.arange(2 * di, 2 * di + 2 * GN),
                           2 * di + 2 * GN + kept])
    conv_ch = np.concatenate([ch, np.arange(di, di + 2 * GN)])

    def take(name, idx, dim):
        w = m[name]
        return w.index_select(dim, torch.as_tensor(idx, dtype=torch.long,
                                                   device=w.device))

    new_m = dict(m)
    new_m["in_proj"] = take("in_proj", cols, 1)
    new_m["conv_w"] = take("conv_w", conv_ch, 0)
    new_m["conv_b"] = take("conv_b", conv_ch, 0)
    for name in ("A_log", "D", "dt_bias"):
        new_m[name] = take(name, kept, 0)
    new_m["norm_scale"] = take("norm_scale", ch, 0)
    new_m["out_proj"] = take("out_proj", ch, 0)
    new_block = dict(block)
    new_block["mamba"] = new_m
    return new_block, dataclasses.replace(spec, d_inner=int(keep) * P)


# ---------------------------------------------------------------- driver

def structured_fractions(targets: dict, cfg: ModelConfig,
                         share: float = 1.0) -> dict:
    """Per-(layer, unit) structured fraction from per-projection targets."""
    out: dict = {}
    for i, spec in enumerate(cfg.layers()):
        if isinstance(spec.mixer, AttentionSpec):
            vals = [targets.get((i, n), 0.0) for n in ("q", "k", "v", "o")]
            out[(i, "heads")] = share * float(np.mean(vals))
        else:
            vals = [targets.get((i, n), 0.0) for n in ("in_proj", "out_proj")]
            out[(i, "mamba")] = share * float(np.mean(vals))
        if spec.ffn is not None:
            names = ("gate", "up", "down")
            vals = [targets[(i, n)] for n in names if (i, n) in targets]
            out[(i, "ffn")] = share * float(np.mean(vals))
    return out


def prune_structured(params, cfg: ModelConfig, fractions: dict,
                     align_heads: int = 1, align_channels: int = 1,
                     expert_frac: float = 0.0):
    """Returns (new_params, new_cfg) with physically smaller projections."""
    if cfg.scan_layers:
        raise ValueError("structured pruning operates on unrolled models")
    new_blocks = []
    new_specs = []
    for i, spec in enumerate(cfg.layers()):
        block = params["blocks"][i]
        if isinstance(spec.mixer, AttentionSpec):
            f = fractions.get((i, "heads"), 0.0)
            block, mixer = prune_attention(block, spec.mixer, f,
                                           align_heads)
        else:
            f = fractions.get((i, "mamba"), 0.0)
            block, mixer = prune_mamba(block, spec.mixer, f, align_heads)
        ffn = spec.ffn
        if isinstance(ffn, MoESpec):
            if expert_frac > 0.0:
                block, ffn = prune_experts(block, ffn, expert_frac)
            f = fractions.get((i, "ffn"), 0.0)
            block, ffn = prune_moe(block, ffn, f, align_channels)
        elif isinstance(ffn, MLPSpec):
            f = fractions.get((i, "ffn"), 0.0)
            block, ffn = prune_mlp(block, ffn, f, align_channels)
        new_blocks.append(block)
        new_specs.append(LayerSpec(mixer=mixer, ffn=ffn))
    new_params = dict(params)
    new_params["blocks"] = new_blocks
    new_cfg = cfg.replace(pattern=tuple(new_specs), n_periods=1,
                          scan_layers=False)
    return new_params, new_cfg


@register_category("structured")
def _category_structured(params, cfg, targets, artifact, recipe):
    """Physical-only pruning: maximum shrink for memory-bound targets."""
    fractions = structured_fractions(targets, cfg, share=1.0)
    params, new_cfg = prune_structured(
        params, cfg, fractions, align_heads=recipe.align_heads,
        align_channels=recipe.align_channels)
    return params, new_cfg, {"structured_fractions": fractions}
