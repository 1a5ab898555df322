"""Decoder: embedding -> [LayerSpec...] -> norm -> LM head.

Layers run in a Python loop over per-layer params (``blocks`` is a
list). A layer's mixer is GQA attention or a Mamba-2 SSD mixer
(``models/ssm.py``); its feed-forward a dense MLP, an MoE layer
(``models/moe.py``) or none. The forward runs unrolled stacks only: a
scanned (period-stacked) checkpoint is unstacked at load
(``common/interop.py::unstack_blocks``). Frontend embeddings (the
stubbed vision or audio frontend's ``(B, F, d)`` output) replace the
first F positions' token embeddings, after the embed scale, as in the
JAX package.

``loss_fn`` runs the forward with ``train=True``: the plain attention
and SSD paths the reference trains on (the kernels have no backward),
each block under activation checkpointing when ``cfg.remat`` is set.

With the span log on (``common/spans.py``) the forward records an
``embed`` span, a ``block`` span per layer (``apply_block`` an ``attn``
or ``mamba`` span inside it) and a ``head`` span: host time only.

Under an active mesh (``distributed/axes.py::use_mesh``) params, tokens
and caches are DTensors (``distributed/sharding.py``) and the JAX
package's hints lay the residual stream out as it does: the batch over
the data axes, the sequence over ``residual_seq`` when a rule maps it.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common.spans import LOG as SPANS
from repro_torch.common.tree import cast_tree
from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import hint
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.specs import (AttentionSpec, LayerSpec, MambaSpec,
                                      MLPSpec, ModelConfig, MoESpec)


def _check_ported(spec: LayerSpec) -> None:
    if not isinstance(spec.mixer, (AttentionSpec, MambaSpec)):
        raise NotImplementedError(
            f"{type(spec.mixer).__name__} mixers are not ported yet")
    if spec.ffn is not None and not isinstance(spec.ffn,
                                               (MLPSpec, MoESpec)):
        raise NotImplementedError(
            f"{type(spec.ffn).__name__} feed-forwards are not ported yet")


def _check_unrolled(cfg: ModelConfig) -> None:
    if cfg.scan_layers:
        raise NotImplementedError(
            "scanned stacks are not ported; use cfg.replace("
            "scan_layers=False) or cfg.unrolled()")


# ---------------------------------------------------------------- init

def init_block(gen: torch.Generator, cfg: ModelConfig, spec: LayerSpec,
               dtype=torch.float32) -> dict:
    _check_ported(spec)
    dev = L.gen_device(gen)
    p: dict[str, Any] = {"norm1": L.init_norm(cfg.norm, cfg.d_model, dtype,
                                              dev)}
    if isinstance(spec.mixer, AttentionSpec):
        p["attn"] = L.init_attention(gen, cfg.d_model, spec.mixer, dtype)
    else:
        p["mamba"] = SSM.init_mamba(gen, cfg.d_model, spec.mixer, dtype)
    if spec.ffn is not None:
        p["norm2"] = L.init_norm(cfg.norm, cfg.d_model, dtype, dev)
        if isinstance(spec.ffn, MoESpec):
            p["moe"] = MOE.init_moe(gen, cfg.d_model, spec.ffn, dtype)
        else:
            p["mlp"] = L.init_mlp(gen, cfg.d_model, spec.ffn, dtype)
    return p


def init_model(gen: torch.Generator, cfg: ModelConfig,
               dtype=torch.float32) -> dict:
    """Random params on ``gen``'s device, drawn from ``gen`` in a fixed
    order (embedding, head, then the blocks in layer order). With
    ``gen=None`` the tree holds ``meta`` tensors: the shapes and dtypes
    a checkpoint of ``cfg`` restores into, with nothing allocated."""
    _check_unrolled(cfg)
    Vp, d = cfg.padded_vocab, cfg.d_model
    params: dict[str, Any] = {
        "embed": {"table": L._randn(gen, (Vp, d), 0.02, dtype)},
        "final_norm": L.init_norm(cfg.norm, d, dtype,
                                  L.gen_device(gen)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": L._randn(gen, (d, Vp), d ** -0.5, dtype)}
    params["blocks"] = [init_block(gen, cfg, cfg.layer(i), dtype)
                        for i in range(cfg.n_layers)]
    return params


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Floating leaves to ``dtype`` (the engines' one cast at start-up),
    except the Mamba leaves the JAX package keeps in f32 whatever the
    compute dtype (``ssm.F32_LEAVES``)."""
    out = cast_tree(params, dtype)
    for blk, new in zip(params["blocks"], out["blocks"]):
        if "mamba" in blk:
            for name in SSM.F32_LEAVES:
                new["mamba"][name] = blk["mamba"][name]
    return out


# ---------------------------------------------------------------- cache

def init_block_cache(batch: int, s_max: int, spec: LayerSpec,
                     dtype=torch.bfloat16, device=None) -> dict:
    _check_ported(spec)
    if isinstance(spec.mixer, AttentionSpec):
        return {"attn": L.init_attention_cache(batch, s_max, spec.mixer,
                                               dtype, device)}
    return {"mamba": SSM.init_mamba_cache(batch, spec.mixer, dtype, device)}


def init_cache(cfg: ModelConfig, batch: int, s_max: int,
               dtype=torch.bfloat16, device=None) -> list:
    _check_unrolled(cfg)
    return [init_block_cache(batch, s_max, cfg.layer(i), dtype, device)
            for i in range(cfg.n_layers)]


# ------------------------------------------------------------- slot pool

def init_cache_pool(cfg: ModelConfig, max_slots: int, max_seq: int,
                    dtype=torch.bfloat16, device=None) -> list:
    """A fixed ``(max_slots, max_seq)`` KV pool for continuous batching:
    an ordinary cache whose batch axis is the slot axis (a Mamba layer's
    conv carry and state have one row per slot). Sequences are
    prefilled into single slots (``write_cache_slot``) and decoded at
    per-slot offsets (a vector ``cache_index`` in ``forward``)."""
    return init_cache(cfg, max_slots, max_seq, dtype, device)


def init_paged_pool(cfg: ModelConfig, n_blocks: int, block_size: int,
                    dtype=torch.bfloat16, device=None) -> list:
    """A paged KV pool: per attention layer one ``(n_blocks + 1,
    block_size, n_kv, D)`` arena of fixed-size KV blocks shared by every
    request through per-request block tables (``block_tables`` in
    ``forward``). The extra last block (index ``n_blocks``) is the
    scratch block: right-padded prefill positions and inactive decode
    slots write there; the allocator never hands it out.

    Attention-only configs: an SSM mixer's state is recurrent, not
    positional, so it has nothing to page."""
    _check_unrolled(cfg)
    pool = []
    for i in range(cfg.n_layers):
        spec = cfg.layer(i)
        _check_ported(spec)
        if not isinstance(spec.mixer, AttentionSpec):
            raise ValueError("paged KV pools support attention mixers "
                             f"only (layer {i} is {type(spec.mixer).__name__})")
        pool.append({"attn": L.init_paged_attention_cache(
            n_blocks + 1, block_size, spec.mixer, dtype, device)})
    return pool


def copy_pool_block(pool: list, src: int, dst: int) -> list:
    """Copy arena block ``src`` -> ``dst`` in every layer of a paged pool,
    in place (the device half of copy-on-write); returns the pool."""
    for layer in pool:
        for arena in layer["attn"].values():
            arena[dst].copy_(arena[src])
    return pool


def write_cache_slot(pool: list, row: list, slot: int) -> list:
    """Copy a batch-1 cache ``row`` (from a B=1 prefill) into slot
    ``slot`` of ``pool``, in place: the K/V rows of attention layers, the
    conv carry and state of Mamba layers. Returns the pool."""
    for p_layer, r_layer in zip(pool, row):
        for kind, leaves in p_layer.items():
            for name, arena in leaves.items():
                arena[slot].copy_(r_layer[kind][name][0])
    return pool


# ---------------------------------------------------------------- forward

def apply_block(block_params: dict, cfg: ModelConfig, spec: LayerSpec,
                x: torch.Tensor, positions: torch.Tensor,
                cache: Optional[dict], cache_index, layer: int = 0,
                mlp_apply=None, block_tables=None, n_valid=None,
                paged_kernel: bool = False, train: bool = False,
                step: Optional[L.PagedStep] = None):
    """Returns (x, new_cache, aux). ``mlp_apply(block_params, ffn_spec,
    h, layer)`` replaces the feed-forward, dense MLP or MoE, when given
    (the serving block-sparse path; it drops the MoE aux loss).
    ``train``: the mixers' plain paths (see ``forward``). ``step``: the
    paged forward's shared tables (``layers.paged_step``)."""
    _check_ported(spec)
    kind = "attn" if isinstance(spec.mixer, AttentionSpec) else "mamba"
    k = SPANS.open(kind) if SPANS.on else -1
    h = L.apply_norm(block_params["norm1"], cfg.norm, x)
    if kind == "attn":
        mix, nc = L.apply_attention(
            block_params["attn"], spec.mixer, h, positions,
            cache["attn"] if cache is not None else None, cache_index,
            block_tables=block_tables, n_valid=n_valid,
            paged_kernel=paged_kernel, train=train, step=step)
    else:
        mix, nc = SSM.apply_mamba(block_params["mamba"], spec.mixer, h,
                                  cache["mamba"] if cache is not None
                                  else None, train=train)
    new_cache = {kind: nc} if nc is not None else {}
    x = x + mix
    if k >= 0:
        SPANS.close(k)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if spec.ffn is not None:
        h = L.apply_norm(block_params["norm2"], cfg.norm, x)
        if mlp_apply is not None:
            y = mlp_apply(block_params, spec.ffn, h, layer)
        elif isinstance(spec.ffn, MoESpec):
            y, aux = MOE.apply_moe(block_params["moe"], spec.ffn, h)
        else:
            y = L.apply_mlp(block_params["mlp"], spec.ffn, h)
        x = x + y
    return x, (new_cache if cache is not None else None), aux


def forward(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None,
            frontend_embeds: Optional[torch.Tensor] = None,
            cache=None, cache_index=None,
            compute_dtype=torch.bfloat16, mlp_apply=None,
            block_tables: Optional[torch.Tensor] = None,
            n_valid: Optional[torch.Tensor] = None,
            paged_kernel: bool = False, train: bool = False):
    """Returns (logits, new_cache, aux_loss).

    tokens: (B, S) integer tensor on the params' device.
    frontend_embeds: (B, F, d) stub embeddings that take the place of
    the first F positions' token embeddings (cast to ``compute_dtype``;
    the tokens there are ignored). cache +
    cache_index: decode mode (tokens are the new step(s)); cache_index
    is an int / 0-d tensor or a per-sequence (B,) tensor. The cache is
    updated in place and also returned. mlp_apply: optional
    ``(block_params, ffn_spec, x, layer) -> y`` override for FFN layers
    (``ffn_spec`` an ``MLPSpec`` or ``MoESpec``).
    block_tables: (B, max_blocks) — ``cache`` is a paged pool
    (``init_paged_pool``) read and written through each sequence's
    table row; ``n_valid`` (B,) masks right-padded prefill positions
    into the scratch block; ``paged_kernel`` sends paged decode steps
    (S == 1) through the paged-attention op. With no mesh active the
    tables every layer of a paged step shares (cos and sin of the
    positions, the arena rows, the lengths) are built once, before the
    layers (``layers.paged_step``), and each layer's RoPE and K/V write
    run as one op on them.
    train: the differentiable route ``loss_fn`` takes, and the engines
    never do: attention over more than ``DENSE_ATTN_MAX`` causal
    positions runs the plain chunked path and Mamba layers the plain
    chunked scan, on any device, so no kernel is launched; with
    ``cfg.remat`` each block runs under ``torch.utils.checkpoint`` (its
    activations recomputed in the backward pass), as ``jax.checkpoint``
    wraps each block in the JAX package.
    """
    _check_unrolled(cfg)
    B, S = tokens.shape
    dev = tokens.device
    k = SPANS.open("embed") if SPANS.on else -1
    if positions is None:
        ar = torch.arange(S, device=dev)[None, :]
        if cache_index is not None:
            ci = (cache_index.to(dev) if isinstance(cache_index, torch.Tensor)
                  else torch.tensor(int(cache_index), device=dev))
            ci = ci[:, None] if ci.dim() else ci
            positions = (ci + ar).expand(B, S)
        else:
            positions = ar.expand(B, S)

    x = params["embed"]["table"][tokens.long()].to(compute_dtype)
    x = hint(x, "batch", "seq", "embed")
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=compute_dtype)
    if frontend_embeds is not None:
        F = frontend_embeds.shape[1]
        x = torch.cat([frontend_embeds.to(compute_dtype), x[:, F:]], dim=1)
    if k >= 0:
        SPANS.close(k)

    step = None
    if (block_tables is not None and cache is not None
            and AX.active_mesh() is None):
        step = L.paged_step(
            [spec.mixer for spec in map(cfg.layer, range(cfg.n_layers))
             if isinstance(spec.mixer, AttentionSpec)],
            positions, cache[0]["attn"]["k"], block_tables, cache_index,
            n_valid)

    aux_total = torch.zeros((), dtype=torch.float32, device=dev)
    x = hint(x, "batch", "residual_seq", "embed")
    new_cache = [] if cache is not None else None
    for i in range(cfg.n_layers):
        k = SPANS.open("block", layer=i) if SPANS.on else -1
        ci = cache[i] if cache is not None else None
        args = (params["blocks"][i], cfg, cfg.layer(i), x, positions, ci,
                cache_index)
        kw = dict(layer=i, mlp_apply=mlp_apply, block_tables=block_tables,
                  n_valid=n_valid, paged_kernel=paged_kernel, train=train,
                  step=step)
        if train and cfg.remat:
            x, nci, a = checkpoint(apply_block, *args, use_reentrant=False,
                                   **kw)
        else:
            x, nci, a = apply_block(*args, **kw)
        x = hint(x, "batch", "residual_seq", "embed")
        aux_total = aux_total + a
        if cache is not None:
            new_cache.append(nci)
        if k >= 0:
            SPANS.close(k)

    k = SPANS.open("head") if SPANS.on else -1
    x = L.apply_norm(params["final_norm"], cfg.norm, x)
    if cfg.tie_embeddings:
        head = params["embed"]["table"].to(compute_dtype).T
    else:
        head = params["lm_head"]["w"].to(compute_dtype)
    # under a mesh on each rank's rows and vocab slice, the head's
    # embed dim gathered whole (as FSDP gathers a weight)
    rows = ("batch", "residual_seq", None)
    logits = AX.on_shards(lambda x, w: x @ w, {0: rows, 1: (None, "vocab")},
                          (rows[:2] + ("vocab",), x.shape[:2] + head.shape[1:]),
                          x, head)
    if k >= 0:
        SPANS.close(k)
    return logits, new_cache, aux_total


# ---------------------------------------------------------------- losses

def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: Optional[int] = None) -> torch.Tensor:
    """Mean next-token CE. logits: (B, S, Vp) (padded vocab ok), labels:
    (B, S). The padded columns get -1e30 added, as in the JAX package.
    Under a mesh each token's term on its rank's rows, the vocab
    gathered whole."""
    def per_token(logits, labels):
        logits = logits.float()
        if vocab is not None and vocab < logits.shape[-1]:
            pad = logits.shape[-1] - vocab
            logits = logits + torch.cat([
                torch.zeros(vocab, device=logits.device),
                torch.full((pad,), -1e30, device=logits.device)])
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        return logz - gold
    rows = ("batch", "seq")
    return AX.on_shards(per_token, {0: rows + (None,), 1: rows},
                        (rows, labels.shape), logits, labels).mean()


def loss_fn(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, frontend_embeds=None,
            compute_dtype=torch.bfloat16, aux_weight: float = 0.01):
    """Returns ``(ce + aux_weight * aux, (ce, aux))`` of a ``train=True``
    forward: the training objective, differentiable in ``params`` (and
    in ``frontend_embeds``, when given)."""
    logits, _, aux = forward(params, cfg, tokens,
                             frontend_embeds=frontend_embeds,
                             compute_dtype=compute_dtype, train=True)
    ce = cross_entropy(logits, labels, cfg.vocab)
    ce, aux = hint(ce), hint(aux)          # replicated under a mesh
    return ce + aux_weight * aux, (ce, aux)
