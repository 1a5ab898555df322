"""Train step: loss and gradients with microbatch accumulation.

Gradient accumulation keeps a large global batch's activations from
living at once: the batch is split on its leading axis, each microbatch
runs forward and backward, and the gradients are summed in
``accum_dtype``, each divided by the number of microbatches. Activation
checkpointing is the forward's (``cfg.remat``, see
``models/transformer.py::forward``).

On a mesh (``mesh``: params and batch as DTensors, from
``distributed/sharding.py``) the loss runs under ``axes.use_mesh``; the
cast of the f32 masters to the compute dtype is elementwise, so it stays
shard-local (laid out by ``param_specs`` when given) before any
all-gather, and each microbatch is laid out by ``batch_spec``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.common.tree import tree_map, zip_leaves
from repro_torch.distributed import axes as AX
from repro_torch.distributed.sharding import batch_axes, map_tree_specs
from repro_torch.models import transformer as T
from repro_torch.models.specs import ModelConfig
from repro_torch.train import optimizer as OPT


def cast_for_compute(params, dtype: torch.dtype):
    """Every floating leaf to ``dtype``, differentiably, so gradients land
    on the f32 masters. Unlike the engines' ``transformer.cast_params``
    it keeps no leaf in f32: the JAX train step rounds the Mamba leaves
    (``A_log``, ``D``, ``dt_bias``) to the compute dtype too."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def value_and_grad(fn: Callable) -> Callable:
    """``fn(tree, *args) -> (value, aux)`` to ``g(tree, *args) ->
    ((value, aux), grads)``: the gradient of the 0-d ``value`` with
    respect to every floating leaf of ``tree``, as a tree of the same
    structure (a leaf the value does not depend on gets zeros), as
    ``jax.value_and_grad(fn, has_aux=True)`` returns it. The leaves of
    ``tree`` are not changed: the gradient is taken through detached
    aliases of them. A DTensor leaf's gradient is laid out as the leaf,
    and a DTensor value and aux come back as plain tensors."""
    def wrapped(tree, *args):
        inputs = []

        def alias(x):
            if not x.is_floating_point():
                return x
            a = x.detach().requires_grad_(True)
            inputs.append(a)
            return a
        with torch.enable_grad():
            shadow = tree_map(alias, tree)
            value, aux = fn(shadow, *args)
            grads = torch.autograd.grad(value, inputs, allow_unused=True)
        it = iter(zip(inputs, grads))

        def grad_of(x):
            if not x.is_floating_point():
                return None
            a, g = next(it)
            if g is None:
                return torch.zeros_like(a)
            if AX.is_dtensor(g) and g.placements != a.placements:
                g = g.redistribute(a.device_mesh, a.placements)
            return g
        out = tree_map(grad_of, tree)
        return (AX.full(value.detach()),
                tree_map(lambda t: AX.full(t.detach()), aux)), out
    return wrapped


def make_loss_fn(cfg: ModelConfig, compute_dtype=torch.bfloat16,
                 aux_weight: float = 0.01, mesh=None,
                 param_specs=None) -> Callable:
    """``loss_fn(params, tokens, labels, frontend_embeds=None) -> (loss,
    (ce, aux))`` over the f32 masters cast to ``compute_dtype``. On
    ``mesh`` (DTensor params) call it, and take its gradient, under
    ``axes.use_mesh(mesh)``."""
    def cast(params):
        params = cast_for_compute(params, compute_dtype)
        if mesh is None or param_specs is None:
            return params
        return map_tree_specs(
            lambda x, spec: AX.to_placements(x, mesh, spec), params,
            param_specs)

    def loss_fn(params, tokens, labels, frontend_embeds=None):
        return T.loss_fn(cast(params), cfg, tokens, labels,
                         frontend_embeds=frontend_embeds,
                         compute_dtype=compute_dtype, aux_weight=aux_weight)
    return loss_fn


def make_train_step(cfg: ModelConfig, opt_cfg: OPT.OptConfig,
                    n_microbatches: int = 1,
                    compute_dtype=torch.bfloat16,
                    aux_weight: float = 0.01,
                    accum_dtype=torch.float32, mesh=None,
                    batch_spec=None, param_specs=None) -> Callable:
    """Returns ``train_step(state, tokens, labels, frontend_embeds=None)
    -> (state, metrics)``; ``state = {'params': ..., 'opt': ...}`` is
    updated in place (``optimizer.apply_updates``) and returned. With
    ``n_microbatches > 1`` the batch (tokens, labels: (B, S) tensors on
    the params' device; frontend_embeds: (B, F, d)) is split on the
    leading axis; loss, ce and aux are averaged the same way as the
    gradients. On ``mesh`` the params are DTensors laid out by
    ``param_specs`` (the unrolled config's) and each microbatch is laid
    out by ``batch_spec`` (its leading dims' spec; default the batch over
    the data axes)."""
    value_grad = value_and_grad(make_loss_fn(cfg, compute_dtype, aux_weight,
                                             mesh=mesh,
                                             param_specs=param_specs))

    def grad_fn(*args):
        with AX.use_mesh(mesh):
            return value_grad(*args)

    def micro(x, rows):
        """Rows ``rows`` of a batch tensor, laid out by ``batch_spec``."""
        if x is None:
            return None
        if mesh is None:
            return x[rows]
        x = AX.full(x)[rows]
        spec = (tuple(batch_spec) if batch_spec is not None
                else (batch_axes(mesh, x.shape[0]),))
        return AX.to_placements(x, mesh, (spec + (None,) * x.dim())[:x.dim()])

    def train_step(state, tokens, labels, frontend_embeds=None):
        params = state["params"]
        if n_microbatches == 1:
            all_rows = slice(None)
            (loss, (ce, aux)), grads = grad_fn(
                params, micro(tokens, all_rows), micro(labels, all_rows),
                micro(frontend_embeds, all_rows))
        else:
            B = tokens.shape[0]
            if B % n_microbatches:
                raise ValueError(f"batch {B} does not split into "
                                 f"{n_microbatches} microbatches")
            mb = B // n_microbatches
            grads = tree_map(lambda x: torch.zeros_like(x, dtype=accum_dtype),
                             params)
            loss = ce = aux = torch.zeros((), device=tokens.device)
            n = n_microbatches
            for i in range(n):
                rows = slice(i * mb, (i + 1) * mb)
                (lo, (ce_i, aux_i)), g = grad_fn(
                    params, micro(tokens, rows), micro(labels, rows),
                    micro(frontend_embeds, rows))
                for a, b in zip_leaves(grads, g):
                    a.copy_(a.float() + b.float() / n)
                loss = loss + lo / n
                ce = ce + ce_i / n
                aux = aux + aux_i / n
        new_params, new_opt, stats = OPT.apply_updates(
            params, grads, state["opt"], opt_cfg)
        metrics = {"loss": loss, "ce": ce, "aux": aux, **stats}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_train_state(gen: torch.Generator, cfg: ModelConfig,
                     opt_cfg: OPT.OptConfig,
                     param_dtype=torch.float32, period=None) -> dict:
    """Random params on ``gen``'s device and a zero optimizer state
    (``period``: see ``optimizer.init_opt``)."""
    params = T.init_model(gen, cfg, dtype=param_dtype)
    return {"params": params,
            "opt": OPT.init_opt(params, opt_cfg, period=period)}
