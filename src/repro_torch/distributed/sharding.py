"""Parameter, cache and input sharding policies for the production mesh,
and the placement of trees on a mesh.

2-D (data x model) layout plus an optional pod axis:
  - weights: FSDP over 'data' on the embed dimension, tensor-parallel
    over 'model' on heads / ffn / vocab / experts (ZeRO-3 + Megatron);
  - attention heads that do not divide the model axis fall back to
    head_dim sharding; the dims that divide nothing are replicated;
  - scanned stacks get a leading None (the period axis is never
    sharded).

The spec functions are pure: they read only the mesh's axis sizes, and
return the JAX package's specs as tuples. ``shard_params``,
``shard_cache`` and ``shard_inputs`` build DTensors with
``distribute_tensor``. The port's forward runs unrolled, so a scanned
params tree is unstacked (``common/interop.py::unstack_blocks``) and
each block takes its ``cfg.unrolled()`` spec.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.common.interop import unstack_blocks
from repro_torch.distributed.axes import (axis_sizes, mesh_size,
                                          spec_placements)
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MambaSpec,
                                      MLPSpec, ModelConfig, MoESpec)

DP_AXES = ("pod", "data")


def _fit(mesh, dim: int, axis):
    """axis if it exists in mesh and divides dim, else None."""
    if axis is None:
        return None
    sizes = axis_sizes(mesh)
    if isinstance(axis, tuple):
        axis = tuple(a for a in axis if a in sizes)
        if not axis:
            return None
        if dim % mesh_size(mesh, axis):
            return None
        return axis[0] if len(axis) == 1 else axis    # as P() normalises
    if axis not in sizes:
        return None
    return axis if dim % mesh_size(mesh, axis) == 0 else None


def batch_axes(mesh, dim: int):
    """Shard batch over (pod, data) with a fallback to data, then none."""
    for cand in (DP_AXES, "data", None):
        ax = _fit(mesh, dim, cand)
        if ax is not None or cand is None:
            return ax
    return None


def attn_param_specs(mesh, spec: AttentionSpec, d_model: int) -> dict:
    fsdp = _fit(mesh, d_model, "data")

    def qkv(n_heads):
        if _fit(mesh, n_heads, "model"):
            return (fsdp, "model", None), ("model", None)
        if _fit(mesh, spec.head_dim, "model"):
            return (fsdp, None, "model"), (None, "model")
        return (fsdp, None, None), (None, None)

    q_spec, qb_spec = qkv(spec.n_q)
    kv_spec, kvb_spec = qkv(spec.n_kv)
    if _fit(mesh, spec.n_q, "model"):
        o_spec = ("model", None, fsdp)
    elif _fit(mesh, spec.head_dim, "model"):
        o_spec = (None, "model", fsdp)
    else:
        o_spec = (None, None, fsdp)
    out = {"q": q_spec, "k": kv_spec, "v": kv_spec, "o": o_spec}
    if spec.qkv_bias:
        out["q_bias"] = qb_spec
        out["k_bias"] = kvb_spec
        out["v_bias"] = kvb_spec
    return out


def mlp_param_specs(mesh, spec: MLPSpec, d_model: int) -> dict:
    fsdp = _fit(mesh, d_model, "data")
    ff = _fit(mesh, spec.d_ff, "model")
    out = {"up": (fsdp, ff), "down": (ff, fsdp)}
    if spec.gated:
        out["gate"] = (fsdp, ff)
    return out


def moe_param_specs(mesh, spec: MoESpec, d_model: int) -> dict:
    fsdp = _fit(mesh, d_model, "data")
    ep = _fit(mesh, spec.n_experts, "model")
    out = {"router": (fsdp, None),
           "up": (ep, fsdp, None),
           "down": (ep, None, fsdp)}
    if spec.gated:
        out["gate"] = (ep, fsdp, None)
    if spec.n_shared:
        shared_ff = spec.d_ff * spec.n_shared
        out["shared"] = {
            "up": (fsdp, _fit(mesh, shared_ff, "model")),
            "down": (_fit(mesh, shared_ff, "model"), fsdp),
        }
        if spec.gated:
            out["shared"]["gate"] = out["shared"]["up"]
    return out


def mamba_param_specs(mesh, spec: MambaSpec, d_model: int) -> dict:
    fsdp = _fit(mesh, d_model, "data")
    inner = _fit(mesh, spec.d_inner, "model")
    return {
        # the mixed [z|x|B|C|dt] column layout sharded over model: slice
        # boundaries cross shards, and the slices are redistributed
        "in_proj": (fsdp, _fit(mesh, spec.in_dim, "model")),
        "conv_w": (None, None),
        "conv_b": (None,),
        "A_log": (None,),
        "D": (None,),
        "dt_bias": (None,),
        "norm_scale": (inner,),
        "out_proj": (inner, fsdp),
    }


def block_param_specs(mesh, cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    out = {"norm1": {"scale": (None,)}}
    if cfg.norm == "layernorm":
        out["norm1"]["bias"] = (None,)
    if isinstance(spec.mixer, AttentionSpec):
        out["attn"] = attn_param_specs(mesh, spec.mixer, d)
    else:
        out["mamba"] = mamba_param_specs(mesh, spec.mixer, d)
    if spec.ffn is not None:
        out["norm2"] = {"scale": (None,)}
        if cfg.norm == "layernorm":
            out["norm2"]["bias"] = (None,)
        if isinstance(spec.ffn, MoESpec):
            out["moe"] = moe_param_specs(mesh, spec.ffn, d)
        else:
            out["mlp"] = mlp_param_specs(mesh, spec.ffn, d)
    return out


def is_spec(x) -> bool:
    """A spec: a tuple whose entries are axis names, tuples of names or
    None (a tuple of subtrees is a scanned ``blocks`` node)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_specs(fn, tree):
    """``fn`` applied to every spec of a spec tree."""
    if is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_specs(fn, v) for v in tree)
    return tree


def map_tree_specs(fn, tree, specs):
    """``fn(leaf, spec)`` at every leaf of ``tree``, walking ``specs``
    (a spec tree of the same structure) alongside."""
    if isinstance(tree, dict):
        return {k: map_tree_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not is_spec(specs):
        return type(tree)(map_tree_specs(fn, v, s)
                          for v, s in zip(tree, specs))
    return None if tree is None else fn(tree, specs)


def _prepend_axis(tree):
    return map_specs(lambda s: (None,) + s, tree)


def param_specs(mesh, cfg: ModelConfig) -> dict:
    """Spec tree matching ``init_model``'s structure (the JAX package's:
    a tuple of period-stacked slot trees for a scanned config)."""
    vocab = _fit(mesh, cfg.padded_vocab, "model")
    fsdp = _fit(mesh, cfg.d_model, "data")
    out = {"embed": {"table": (vocab, fsdp)},
           "final_norm": {"scale": (None,)}}
    if cfg.norm == "layernorm":
        out["final_norm"]["bias"] = (None,)
    if not cfg.tie_embeddings:
        out["lm_head"] = {"w": (fsdp, vocab)}
    if cfg.scan_layers:
        out["blocks"] = tuple(
            _prepend_axis(block_param_specs(mesh, cfg, spec))
            for spec in cfg.pattern)
    else:
        out["blocks"] = [block_param_specs(mesh, cfg, cfg.layer(i))
                         for i in range(cfg.n_layers)]
    return out


# ---------------------------------------------------------------- caches

def attn_cache_specs(mesh, spec: AttentionSpec, batch: int) -> dict:
    b = batch_axes(mesh, batch)
    if _fit(mesh, spec.n_kv, "model"):
        kv = (b, None, "model", None)
    elif _fit(mesh, spec.head_dim, "model"):
        kv = (b, None, None, "model")
    else:
        kv = (b, None, None, None)
    return {"k": kv, "v": kv}


def mamba_cache_specs(mesh, spec: MambaSpec, batch: int) -> dict:
    b = batch_axes(mesh, batch)
    heads = _fit(mesh, spec.n_heads, "model")
    return {"conv": (b, None, None), "state": (b, heads, None, None)}


def cache_specs(mesh, cfg: ModelConfig, batch: int):
    def block(spec: LayerSpec):
        if isinstance(spec.mixer, AttentionSpec):
            return {"attn": attn_cache_specs(mesh, spec.mixer, batch)}
        return {"mamba": mamba_cache_specs(mesh, spec.mixer, batch)}
    if cfg.scan_layers:
        return tuple(_prepend_axis(block(s)) for s in cfg.pattern)
    return [block(cfg.layer(i)) for i in range(cfg.n_layers)]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the port's counterpart of JAX's."""
    mesh: Any
    spec: tuple

    def place(self, x: torch.Tensor):
        """A global tensor (the same on every rank) laid out by ``spec``
        on the mesh's device."""
        return distribute(x, self.mesh, self.spec)


def param_shardings(mesh, cfg: ModelConfig):
    return map_specs(lambda s: NamedSharding(mesh, s), param_specs(mesh, cfg))


# ------------------------------------------------------- optimizer state

def _drop_axis(spec: tuple, axis_from_end: int) -> tuple:
    parts = list(spec)
    if len(parts) >= axis_from_end:
        del parts[len(parts) - axis_from_end]
    return tuple(parts)


def factorable(shape) -> bool:
    """A leaf of this (global) shape gets a factored second moment."""
    return len(shape) >= 2 and shape[-1] >= 2 and shape[-2] >= 2


def v_spec(shape, spec: tuple) -> dict:
    """A factored second moment's spec for a leaf of ``shape`` laid out
    by ``spec``: ``{"row": spec without its last axis, "col": spec
    without its second-to-last}``, or ``{"full": spec}``. Given the
    shape as ``spec``, the factors' shapes."""
    if factorable(shape):
        return {"row": _drop_axis(spec, 1), "col": _drop_axis(spec, 2)}
    return {"full": spec}


def factored_v_specs(pspec_tree, param_struct):
    """``v_spec`` at every leaf of ``param_struct`` (laid out by
    ``pspec_tree``)."""
    return map_tree_specs(lambda leaf, spec: v_spec(tuple(leaf.shape), spec),
                          param_struct, pspec_tree)


def opt_specs(pspec_tree, param_struct, opt_cfg) -> dict:
    """Spec tree of the optimizer state, mirroring the params' (the JAX
    package's rule): ``m`` as the params, ``v`` as the params or, when
    ``opt_cfg.factored``, by ``v_spec``; ``step`` whole."""
    v = (factored_v_specs(pspec_tree, param_struct) if opt_cfg.factored
         else pspec_tree)
    return {"m": pspec_tree, "v": v, "step": ()}


def input_sharding(mesh, batch: int) -> tuple:
    """The spec of a (B, S) token batch."""
    return (batch_axes(mesh, batch), None)


# ------------------------------------------------------ placing trees

def _unrolled(cfg: ModelConfig) -> ModelConfig:
    return cfg.unrolled() if cfg.scan_layers else cfg


def distribute(x: torch.Tensor, mesh, spec):
    """A global tensor (the same on every rank) as a DTensor laid out by
    ``spec`` on ``mesh``; each rank keeps its own shard."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.to(mesh.device_type), mesh,
                             spec_placements(mesh, spec))


def shard_tree(tree, specs, mesh):
    """Every leaf of ``tree`` distributed by the spec at its path."""
    return map_tree_specs(lambda x, spec: distribute(x, mesh, spec), tree,
                          specs)


def unrolled_blocks(blocks, cfg: ModelConfig) -> list:
    """``blocks`` as the port's per-layer list: a scanned (tuple of
    period-stacked slots) tree is unstacked."""
    if isinstance(blocks, tuple):
        return unstack_blocks(blocks, cfg.n_periods)
    return blocks


def shard_params(params: dict, mesh, cfg: ModelConfig) -> dict:
    """The port's (unrolled) params as DTensors laid out by
    ``param_specs``; a scanned tree (JAX's layout) is unstacked first."""
    params = {**params, "blocks": unrolled_blocks(params["blocks"], cfg)}
    return shard_tree(params, param_specs(mesh, _unrolled(cfg)), mesh)


def shard_cache(cache: list, mesh, cfg: ModelConfig, batch: int) -> list:
    """A contiguous (unrolled) cache laid out by ``cache_specs``."""
    return shard_tree(cache, cache_specs(mesh, _unrolled(cfg), batch), mesh)


def shard_inputs(tokens: torch.Tensor, mesh):
    """A token batch (B, ...) laid out with its batch over the data axes
    (``input_sharding``; trailing dims replicated)."""
    spec = (batch_axes(mesh, tokens.shape[0]),) + (None,) * (tokens.dim() - 1)
    return distribute(tokens, mesh, spec)
