"""Core transformer layers: norms, RoPE, GQA attention, MLP (dense half).

Plain functions on tensors in the JAX package's layout: every module is
an ``init_*`` returning a params dict and an ``apply``-style function.
Compute happens in the activation dtype (params cast at use; a cast to
the dtype a tensor already has is free), with norms, softmax and the
attention scores in f32. The paged-cache helpers come with slice 2.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.specs import AttentionSpec, MLPSpec
from repro_torch.models.taps import tap

# Sequences longer than this use the chunked (exact-FLOP) attention
# path; shorter use one dense softmax.
DENSE_ATTN_MAX = 2048
Q_CHUNK = 1024
NEG_INF = -1e30


# ---------------------------------------------------------------- norms

def init_norm(kind: str, dim: int, dtype=torch.float32,
              device=None) -> dict:
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def apply_norm(params: dict, kind: str, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * params["scale"].float()).to(dtype)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(dtype)


# ---------------------------------------------------------------- RoPE

def rope_embed(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S)."""
    half = x.shape[-1] // 2
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------- attention

def _randn(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    return (torch.randn(shape, generator=gen, device=gen.device)
            * scale).to(dtype)


def init_attention(gen: torch.Generator, d_model: int, spec: AttentionSpec,
                   dtype=torch.float32) -> dict:
    """Params on ``gen``'s device: q/k/v (d, heads, D), o (n_q, D, d)."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(spec.n_q * spec.head_dim)
    p = {
        "q": _randn(gen, (d_model, spec.n_q, spec.head_dim), s_in, dtype),
        "k": _randn(gen, (d_model, spec.n_kv, spec.head_dim), s_in, dtype),
        "v": _randn(gen, (d_model, spec.n_kv, spec.head_dim), s_in, dtype),
        "o": _randn(gen, (spec.n_q, spec.head_dim, d_model), s_out, dtype),
    }
    if spec.qkv_bias:
        dev = gen.device
        p["q_bias"] = torch.zeros((spec.n_q, spec.head_dim), dtype=dtype,
                                  device=dev)
        p["k_bias"] = torch.zeros((spec.n_kv, spec.head_dim), dtype=dtype,
                                  device=dev)
        p["v_bias"] = torch.zeros((spec.n_kv, spec.head_dim), dtype=dtype,
                                  device=dev)
    return p


def _dense_attention(q, k, v, q_positions, kv_positions, causal: bool,
                     kv_valid: Optional[torch.Tensor] = None):
    """q: (B,S,nq,D); k,v: (B,T,nkv,D). Returns (B,S,nq,D)."""
    B, S, nq, D = q.shape
    T, nkv = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, nkv, nq // nkv, D)
    scale = 1.0 / math.sqrt(D)
    logits = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    mask = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_positions[:, None, :] <= q_positions[:, :, None]
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    logits = torch.where(mask[:, None, None, :, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.to(q.dtype))
    return out.reshape(B, S, nq, D)


def _chunked_causal_attention(q, k, v, positions):
    """Exact-FLOP causal attention for long sequences: query chunk ``i``
    attends to the kv prefix ``[0, (i+1)*Q_CHUNK)`` only."""
    B, S, nq, D = q.shape
    nkv = k.shape[2]
    group = nq // nkv
    scale = 1.0 / math.sqrt(D)
    qc = Q_CHUNK
    if S % qc:
        raise ValueError(f"seq {S} must be a multiple of {qc} for chunked "
                         f"attention")
    outs = []
    for i in range(S // qc):
        qs = q[:, i * qc:(i + 1) * qc].reshape(B, qc, nkv, group, D)
        kv_len = (i + 1) * qc
        logits = torch.einsum("bskgd,btkd->bkgst", qs.float(),
                              k[:, :kv_len].float()) * scale
        qpos = positions[:, i * qc:(i + 1) * qc]
        kpos = positions[:, :kv_len]
        mask = kpos[:, None, :] <= qpos[:, :, None]
        logits = torch.where(mask[:, None, None, :, :], logits,
                             torch.full((), NEG_INF, device=q.device))
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bkgst,btkd->bskgd", probs,
                                 v[:, :kv_len].to(q.dtype))
                    .reshape(B, qc, nq, D))
    return torch.cat(outs, dim=1)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(B, S, d) @ (d, H, D) -> (B, S, H, D)."""
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).reshape(
        B, S, *w.shape[1:])


def _write_cache(c: torch.Tensor, u: torch.Tensor, ci) -> None:
    """Write ``u`` (B, S, ...) into ``c`` (B, S_max, ...) at sequence
    offset ``ci``: an int (whole batch) or a (B,) tensor (each sequence
    at its own offset). The start is clamped so the write fits, as
    ``dynamic_update_slice`` clamps it in the JAX package. In place."""
    S, S_max = u.shape[1], c.shape[1]
    if isinstance(ci, int):
        start = min(max(ci, 0), S_max - S)
        c[:, start:start + S] = u.to(c.dtype)
        return
    start = ci.clamp(0, S_max - S)
    rows = start[:, None] + torch.arange(S, device=c.device)[None, :]
    batch = torch.arange(c.shape[0], device=c.device)[:, None]
    c[batch, rows] = u.to(c.dtype)


def _cache_index(cache_index):
    """An int for a scalar index (host value), a long tensor for a
    per-sequence (B,) vector."""
    if isinstance(cache_index, torch.Tensor):
        if cache_index.dim() == 0:
            return int(cache_index)
        return cache_index.long()
    return int(cache_index)


def apply_attention(params: dict, spec: AttentionSpec, x: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    cache_index=None):
    """Returns (out, new_cache). cache: {'k','v': (B, S_max, n_kv, D)};
    the step's K/V rows are written into it in place, at ``cache_index``
    (an int or 0-d tensor: the whole batch at one offset; a (B,) tensor:
    each sequence at its own length), and the step attends over the
    whole cache with positions at or past ``cache_index + S`` masked."""
    dtype = x.dtype
    tap("attn_qkv", x)
    q = _project(x, params["q"].to(dtype))
    k = _project(x, params["k"].to(dtype))
    v = _project(x, params["v"].to(dtype))
    if spec.qkv_bias:
        q = q + params["q_bias"].to(dtype)
        k = k + params["k_bias"].to(dtype)
        v = v + params["v_bias"].to(dtype)
    if spec.rope:
        q = rope_embed(q, positions, spec.rope_theta)
        k = rope_embed(k, positions, spec.rope_theta)

    new_cache = None
    B, S = x.shape[0], x.shape[1]
    if cache is not None:
        ci = _cache_index(cache_index)
        ck, cv = cache["k"], cache["v"]
        _write_cache(ck, k, ci)
        _write_cache(cv, v, ci)
        new_cache = {"k": ck, "v": cv}
        if S > DENSE_ATTN_MAX and spec.causal:
            # long prefill: cache content == current tokens (index 0)
            out = _chunked_causal_attention(q, ck[:, :S], cv[:, :S],
                                            positions)
        else:
            S_max = ck.shape[1]
            kv_pos = torch.arange(S_max, device=x.device)[None, :].expand(
                B, S_max)
            end = (ci[:, None] if isinstance(ci, torch.Tensor) else ci) + S
            out = _dense_attention(q, ck, cv, positions, kv_pos,
                                   causal=spec.causal, kv_valid=kv_pos < end)
    elif S > DENSE_ATTN_MAX and spec.causal:
        out = _chunked_causal_attention(q, k, v, positions)
    else:
        out = _dense_attention(q, k, v, positions, positions,
                               causal=spec.causal)
    tap("attn_o", out, channel_axes=(-2, -1))
    o = params["o"].to(dtype)
    y = out.reshape(B * S, -1) @ o.reshape(-1, o.shape[-1])
    return y.reshape(B, S, -1), new_cache


def init_attention_cache(batch: int, s_max: int, spec: AttentionSpec,
                         dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, s_max, spec.n_kv, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------- MLP

def activation(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if name == "relu2":  # squared ReLU (Nemotron / Primer)
        r = F.relu(x)
        return r * r
    raise ValueError(f"unknown activation {name!r}")


def init_mlp(gen: torch.Generator, d_model: int, spec: MLPSpec,
             dtype=torch.float32) -> dict:
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(spec.d_ff)
    p = {"up": _randn(gen, (d_model, spec.d_ff), s_in, dtype),
         "down": _randn(gen, (spec.d_ff, d_model), s_out, dtype)}
    if spec.gated:
        p["gate"] = _randn(gen, (d_model, spec.d_ff), s_in, dtype)
    return p


def apply_mlp(params: dict, spec: MLPSpec, x: torch.Tensor) -> torch.Tensor:
    dtype = x.dtype
    tap("mlp_in", x)
    up = x @ params["up"].to(dtype)
    if spec.gated:
        h = activation(spec.act, x @ params["gate"].to(dtype)) * up
    else:
        h = activation(spec.act, up)
    tap("mlp_down", h)
    return h @ params["down"].to(dtype)
