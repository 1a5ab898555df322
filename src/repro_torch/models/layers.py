"""Core transformer layers: norms, RoPE, GQA attention, MLP (dense half).

Plain functions on tensors in the JAX package's layout: every module is
an ``init_*`` returning a params dict and an ``apply``-style function.
Compute happens in the activation dtype (params cast at use; a cast to
the dtype a tensor already has is free), with norms, softmax and the
attention scores in f32.

Attention reads a contiguous KV cache, or a paged arena through
per-sequence block tables (``paged_step`` / ``paged_gather``). Three
branches launch kernels on CUDA tensors: every paged step with no mesh
(RoPE and the K/V write, ``kernels/rope_kv_write``, on tables the
forward builds once, ``paged_step``), paged decode with
``paged_kernel`` (``kernels/paged_attention``) and causal prefill longer
than ``DENSE_ATTN_MAX`` (``kernels/flash_attention``); on CPU tensors
they run the plain versions, the last the chunked path the JAX package
runs. With ``train`` (set by ``transformer.loss_fn``) a long causal
sequence takes that chunked path on any device: it is the path the
reference trains on, and the kernels have no backward pass.

Under an active mesh (``distributed/axes.py::use_mesh``) the tensors are
DTensors and the JAX package's sharding hints take effect: heads over
'model', the batch over the data axes, and, for train and prefill, the
tensor-parallel head layout (kv expanded to full heads and heads
zero-padded to a multiple of the model axis). Attention itself, the
flash kernel included, runs on each rank's local shards
(``_on_head_shards``); heads are independent, so no kernel sees a
DTensor. With no mesh every hint is a no-op.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import hint, hint_heads, model_axis_size
from repro_torch.kernels.rope_kv_write.ops import rope_kv_write
from repro_torch.kernels.rope_kv_write.ref import (rope_kv_write_ref,
                                                   rope_rotate)
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


def _norm(x: torch.Tensor, scale: torch.Tensor, bias, kind: str,
          eps: float) -> torch.Tensor:
    dtype = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps)
        return (y * scale.float()).to(dtype)
    mean = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    y = y * scale.float() + bias.float()
    return y.to(dtype)


def apply_norm(params: dict, kind: str, x: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Over the last dim; under a mesh on each rank's rows of ``x`` (the
    residual stream's layout, the last dim whole)."""
    rows = (("batch", "residual_seq", None) if x.dim() == 3
            else ("batch",) + (None,) * (x.dim() - 1))
    return AX.on_shards(lambda x, scale, bias: _norm(x, scale, bias, kind,
                                                     eps),
                        {0: rows}, (rows, x.shape), x, params["scale"],
                        params.get("bias"))


# ---------------------------------------------------------------- RoPE

def rope_embed(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D), positions: (B, S). Under a mesh
    on each rank's batch rows and heads (head_dim whole)."""
    heads = ("batch", None, "heads", None)
    return AX.on_shards(lambda x, p: _rope(x, p, theta),
                        {0: heads, 1: ("batch", None)}, (heads, x.shape),
                        x, positions)


def rope_tables(positions: torch.Tensor, half: int,
                theta: float) -> tuple:
    """(cos, sin) of the rotary angles of ``positions`` (B, S): each (B,
    S, half) f32."""
    freqs = torch.exp(-math.log(theta)
                      * torch.arange(half, dtype=torch.float32,
                                     device=positions.device) / half)
    angles = positions[..., None].float() * freqs          # (B, S, half)
    return torch.cos(angles), torch.sin(angles)


def _rope(x: torch.Tensor, positions: torch.Tensor,
          theta: float) -> torch.Tensor:
    return rope_rotate(x, *rope_tables(positions, x.shape[-1] // 2, theta))


# ---------------------------------------------------------------- attention

def gen_device(gen: Optional[torch.Generator]) -> torch.device:
    """Where ``init_*`` puts params: the generator's device, or ``meta``
    (shapes and dtypes only, nothing allocated) when ``gen`` is None."""
    return torch.device("meta") if gen is None else gen.device


def _randn(gen: Optional[torch.Generator], shape, scale: float,
           dtype) -> torch.Tensor:
    if gen is None:
        return torch.empty(shape, dtype=dtype, device="meta")
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
        dev = gen_device(gen)
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


def _long_causal_attention(q, k, v, positions):
    """Causal attention for a prefill longer than ``DENSE_ATTN_MAX``,
    whose positions are ``0 .. S-1`` (a prefill from cache index 0, or
    with no cache): the flash kernel on CUDA tensors, the chunked plain
    path on CPU tensors. Both need ``S % Q_CHUNK == 0``."""
    if q.shape[1] % Q_CHUNK:
        raise ValueError(f"seq {q.shape[1]} must be a multiple of "
                         f"{Q_CHUNK} for long causal attention")
    if q.device.type == "cpu":
        return _chunked_causal_attention(q, k, v, positions)
    from repro_torch.kernels.flash_attention.ops import flash_attention_bshd
    return flash_attention_bshd(q, k.to(q.dtype), v.to(q.dtype))


# ------------------------------------------------------------ paged KV

def _paged_rows(block_tables: torch.Tensor, pos: torch.Tensor,
                block_size: int) -> torch.Tensor:
    """Physical arena rows for logical positions ``pos`` (B, S) through
    per-sequence ``block_tables`` (B, max_blocks)."""
    logical = (pos // block_size).clamp(0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables.long(), 1, logical)
    return phys * block_size + pos % block_size


def _write_rows(block_tables: torch.Tensor, start: torch.Tensor, S: int,
                n_valid: Optional[torch.Tensor], n_rows: int,
                block_size: int) -> torch.Tensor:
    """(B, S) arena rows of logical positions ``start[b] + [0, S)``, with
    positions past ``n_valid[b]`` redirected to the arena's last row (in
    the scratch block)."""
    steps = torch.arange(S, device=start.device)
    pos = start.long()[:, None] + steps[None, :]
    rows = _paged_rows(block_tables, pos, block_size)
    if n_valid is not None:
        ok = steps[None, :] < n_valid.long()[:, None]
        rows = torch.where(ok, rows, torch.full_like(rows, n_rows - 1))
    return rows


def paged_write(cache_kv: torch.Tensor, new: torch.Tensor,
                block_tables: torch.Tensor, start: torch.Tensor,
                n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scatter ``new`` (B, S, n_kv, D) K/V rows into a paged arena
    ``cache_kv`` (n_blocks, block_size, n_kv, D) at logical positions
    ``start[b] + [0, S)`` of each sequence's ``block_tables`` row, in
    place; returns the arena.

    Rows past ``n_valid[b]`` (right-padded prefill positions) are
    redirected into the arena's last block — the scratch block the
    allocator never hands out — so padding never corrupts a live block.

    A paged forward writes through ``rope_kv_write`` on the rows of
    ``paged_step`` instead, which are this function's rows.
    """
    nb, bs = cache_kv.shape[0], cache_kv.shape[1]
    B, S = new.shape[0], new.shape[1]
    flat = cache_kv.view(nb * bs, *cache_kv.shape[2:])
    rows = _write_rows(block_tables, start, S, n_valid, nb * bs, bs)
    flat[rows.reshape(-1)] = new.to(flat.dtype).reshape(B * S,
                                                        *new.shape[2:])
    return cache_kv


class PagedStep(NamedTuple):
    """The tables every attention layer of one paged forward shares
    (``paged_step``): they depend on the step's positions, block tables
    and lengths, never on a layer's activations."""
    rope: dict             # (rope_theta, D / 2) -> (cos, sin) (B, S, D / 2)
    rows: torch.Tensor     # (B, S) int64 arena rows of the step's positions
    lengths: torch.Tensor  # (B,) int32 valid KV positions after the step
    tables: torch.Tensor   # the block tables in int32


def paged_step(specs, positions: torch.Tensor, arena: torch.Tensor,
               block_tables: torch.Tensor, cache_index,
               n_valid: Optional[torch.Tensor] = None) -> PagedStep:
    """Build once what each layer of a paged forward recomputed: cos and
    sin of ``positions`` (B, S) for each distinct (``rope_theta``, head
    width) among the attention ``specs`` that use RoPE, the arena rows
    ``paged_write`` writes (logical positions ``cache_index + [0, S)``,
    padding past ``n_valid`` into the scratch block) for ``arena``'s
    shape, which every layer of a paged pool shares, and the valid
    lengths, with the same ops, so the values are bitwise the per-layer
    ones."""
    B, S = positions.shape
    ci = torch.as_tensor(cache_index, device=positions.device).long()
    if ci.dim() == 0:
        ci = ci.expand(B)
    nb, bs = arena.shape[0], arena.shape[1]
    rows = _write_rows(block_tables, ci, S, n_valid, nb * bs, bs)
    nv = (n_valid.long() if n_valid is not None
          else torch.full((B,), S, device=ci.device, dtype=torch.long))
    rope = {}
    for spec in specs:
        key = (spec.rope_theta, spec.head_dim // 2)
        if spec.rope and key not in rope:
            rope[key] = rope_tables(positions, key[1], key[0])
    return PagedStep(rope, rows, (ci + nv).to(torch.int32),
                     block_tables.to(torch.int32))


def paged_gather(cache_kv: torch.Tensor,
                 block_tables: torch.Tensor) -> torch.Tensor:
    """Gather each sequence's logical KV view (B, max_blocks*block_size,
    n_kv, D) from the paged arena via its block table."""
    nb, bs = cache_kv.shape[0], cache_kv.shape[1]
    flat = cache_kv.view(nb * bs, *cache_kv.shape[2:])
    B, M = block_tables.shape
    rows = (block_tables.long()[:, :, None] * bs
            + torch.arange(bs, device=cache_kv.device)[None, None, :])
    return flat[rows.reshape(B, M * bs)]


def _paged_attention(spec: AttentionSpec, q, k, v, positions, cache: dict,
                     cache_index, block_tables, n_valid, paged_kernel,
                     step: Optional[PagedStep] = None):
    """The paged branch: scatter this step's K/V rows through the block
    tables, then attend over the gathered logical view, or, for a decode
    step with ``paged_kernel``, read the arena in place through the
    paged-attention op. The view width (max_blocks * block_size) is the
    contiguous pool's S_max, so the masked softmax sums equal the
    contiguous path's: rows of unwritten blocks get exact zero
    probability (f32 exp(-1e30 - max) underflows to 0).

    With ``step`` (the forward's shared tables, no mesh) q and k arrive
    unrotated: RoPE of both and the K/V write run as one
    ``rope_kv_write`` op (one launch on CUDA). Without it (under a mesh)
    they arrive rotated: the step's tables are built here, without RoPE,
    and the op's plain version scatters k and v."""
    B, S = q.shape[0], q.shape[1]
    ck, cv = cache["k"], cache["v"]
    if step is None:
        step = paged_step((), positions, ck, block_tables, cache_index,
                          n_valid)
        rope_kv_write_ref(q, k, v, ck, cv, step.rows)
    else:
        rope = (step.rope[(spec.rope_theta, spec.head_dim // 2)]
                if spec.rope else ())
        q = rope_kv_write(q, k, v, ck, cv, step.rows, *rope)
    if paged_kernel and S == 1:
        from repro_torch.kernels.paged_attention.ops import (
            paged_attention_decode)
        out = paged_attention_decode(q, ck, cv, step.tables, step.lengths)
    else:
        kview = paged_gather(ck, block_tables)
        vview = paged_gather(cv, block_tables)
        T_kv = kview.shape[1]
        kv_pos = torch.arange(T_kv, device=q.device)[None, :].expand(B, T_kv)
        out = _dense_attention(q, kview, vview, positions, kv_pos,
                               causal=spec.causal,
                               kv_valid=kv_pos < step.lengths[:, None])
    return out, {"k": ck, "v": cv}


def _project_local(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    B, S, d = x.shape
    return (x.reshape(B * S, d) @ w.reshape(d, -1)).reshape(
        B, S, *w.shape[1:])


def _project(x: torch.Tensor, w: torch.Tensor, kv: bool = False):
    """(B, S, d) @ (d, H, D) -> (B, S, H, D). Under a mesh on local
    shards, contracting over the whole d: the output laid out as
    ``hint_heads`` lays it out (heads, else head_dim, over 'model')."""
    mesh = AX.active_mesh()
    if mesh is None:
        return _project_local(x, w)
    so = AX.heads_spec(mesh, tuple(x.shape[:2]) + tuple(w.shape[1:]), kv)
    return AX.local_map(_project_local, so,
                        ((so[0], None, None), (None,) + so[2:]))(x, w)


def _out_project_local(out: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    B, S = out.shape[:2]
    y = out.reshape(B * S, -1) @ o.reshape(-1, o.shape[-1])
    return y.reshape(B, S, -1)


def _out_project(out: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) @ (H, D, d) -> (B, S, d). Under a mesh on local
    shards laid out by ``hint_heads``: partial sums over the axis that
    splits heads or head_dim, reduced where the output is next laid
    out."""
    mesh = AX.active_mesh()
    if mesh is None:
        return _out_project_local(out, o)
    so = AX.heads_spec(mesh, out.shape)
    return AX.local_map(_out_project_local, (so[0], None, None),
                        (so, so[2:] + (None,)),
                        partial=tuple(a for a in so[2:] if a))(out, o)


def _write_cache(c: torch.Tensor, u: torch.Tensor, ci) -> None:
    """Write ``u`` (B, S, ...) into ``c`` (B, S_max, ...) at sequence
    offset ``ci``: an int (whole batch) or a (B,) tensor (each sequence
    at its own offset). The start is clamped so the write fits, as
    ``dynamic_update_slice`` clamps it in the JAX package. In place; a
    sharded cache (its sequence dim whole) is written shard by shard."""
    if AX.is_dtensor(c):
        u = AX.to_placements(u, c.device_mesh, AX.placements_spec(c))
        if isinstance(ci, torch.Tensor):
            ci = AX.to_placements(ci, c.device_mesh,
                                  AX.placements_spec(c)[:1]).to_local()
        return _write_cache(c.to_local(), u.to_local(), ci)
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


def _on_head_shards(fn, q, k, v, *extra):
    """``fn(q, k, v, *extra)`` — attention, independent across batch rows
    and heads — on each rank's local shards when a mesh is active: the
    batch over the data axes, heads over 'model' when both head counts
    divide it (else whole on every rank), head_dim whole. ``extra``
    tensors (B, ...) split with the batch. With no mesh, ``fn`` as is."""
    mesh = AX.active_mesh()
    if mesh is None:
        return fn(q, k, v, *extra)
    sq = AX.resolve_spec(mesh, q.shape, ("batch", None, "heads", None))
    sk = AX.resolve_spec(mesh, k.shape, ("batch", None, "kv_heads", None))
    if sq[2] is None or sk[2] is None:
        sq, sk = sq[:2] + (None, None), sk[:2] + (None, None)
    se = [(sq[0],) + (None,) * (e.dim() - 1) for e in extra]
    return AX.local_map(fn, sq, (sq, sk, sk, *se))(q, k, v, *extra)


def apply_attention(params: dict, spec: AttentionSpec, x: torch.Tensor,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    cache_index=None,
                    block_tables: Optional[torch.Tensor] = None,
                    n_valid: Optional[torch.Tensor] = None,
                    paged_kernel: bool = False, train: bool = False,
                    step: Optional[PagedStep] = None):
    """Returns (out, new_cache). cache: {'k','v': (B, S_max, n_kv, D)};
    the step's K/V rows are written into it in place, at ``cache_index``
    (an int or 0-d tensor: the whole batch at one offset; a (B,) tensor:
    each sequence at its own length), and the step attends over the
    whole cache with positions at or past ``cache_index + S`` masked.

    With ``block_tables`` (B, max_blocks) the cache is a paged arena
    {'k','v': (n_blocks, block_size, n_kv, D)}; ``n_valid`` (B,) masks
    right-padded positions of a padded (chunked) prefill, and
    ``paged_kernel`` sends decode steps (S == 1) through the
    paged-attention op instead of the gather path. ``step``
    (``paged_step``, given with ``block_tables`` when no mesh is active)
    holds the forward's tables, shared by every layer: the paged branch
    then runs RoPE and the K/V write as one op. ``train`` sends a long
    causal sequence without a cache through the plain chunked path."""
    dtype = x.dtype
    tap("attn_qkv", x)
    q = _project(x, params["q"].to(dtype))
    k = _project(x, params["k"].to(dtype), kv=True)
    v = _project(x, params["v"].to(dtype), kv=True)
    if spec.qkv_bias:
        q = q + params["q_bias"].to(dtype)
        k = k + params["k_bias"].to(dtype)
        v = v + params["v_bias"].to(dtype)
    if spec.rope and step is None:
        q = rope_embed(q, positions, spec.rope_theta)
        k = rope_embed(k, positions, spec.rope_theta)

    # tensor-parallel head layout for train and prefill (a real sequence
    # dim): GQA groups whose heads cannot shard over the model axis get
    # kv expanded to full heads and every head count zero-padded to a
    # multiple of it; the padded heads are sliced off before the
    # o-projection. The cache keeps the compact GQA layout, and decode
    # (S == 1) stays compact. Off with no mesh (tp == 1).
    B, S = x.shape[0], x.shape[1]
    n_q_orig = q.shape[2]
    tp = model_axis_size()
    expand = tp > 1 and bool(spec.n_kv % tp or spec.n_q % tp) and S > 1
    pad_heads = (-spec.n_q) % tp if expand else 0

    def expand_heads(q, k, v):
        k, v = (torch.repeat_interleave(t, spec.n_q // spec.n_kv, dim=2)
                for t in (k, v))
        return tuple(F.pad(t, (0, 0, 0, pad_heads)) for t in (q, k, v))

    def tp_layout(q, k, v):
        if expand:          # on each rank's batch rows, all heads
            rows = AX.resolve_spec(AX.active_mesh(), q.shape,
                                   ("batch", None, None, None))
            q, k, v = AX.local_map(expand_heads, [rows] * 3,
                                   (rows,) * 3)(q, k, v)
        return hint_heads(q), hint_heads(k, kv=True), hint_heads(v, kv=True)

    new_cache = None
    if cache is not None and block_tables is not None:
        out, new_cache = _paged_attention(spec, q, k, v, positions, cache,
                                          cache_index, block_tables,
                                          n_valid, paged_kernel, step)
    elif cache is not None:
        ci = _cache_index(cache_index)
        ck, cv = cache["k"], cache["v"]
        _write_cache(ck, k, ci)
        _write_cache(cv, v, ci)
        new_cache = {"k": ck, "v": cv}
        if S > DENSE_ATTN_MAX and spec.causal:
            # long prefill: cache content == current tokens (index 0)
            q, kq, vq = tp_layout(q, ck[:, :S], cv[:, :S])
            out = _on_head_shards(_long_causal_attention, q, kq, vq,
                                  positions)
        else:
            q, ck, cv = tp_layout(q, ck, cv)
            S_max = ck.shape[1]
            kv_pos = torch.arange(S_max, device=x.device)[None, :].expand(
                B, S_max)
            end = (ci[:, None] if isinstance(ci, torch.Tensor) else ci) + S
            out = _on_head_shards(
                lambda q, k, v, qp, kp, ok: _dense_attention(
                    q, k, v, qp, kp, causal=spec.causal, kv_valid=ok),
                q, ck, cv, positions, kv_pos, kv_pos < end)
    else:
        q, k, v = tp_layout(q, k, v)
        if S > DENSE_ATTN_MAX and spec.causal:
            long_attention = (_chunked_causal_attention if train
                              else _long_causal_attention)
            out = _on_head_shards(long_attention, q, k, v, positions)
        else:
            out = _on_head_shards(
                lambda q, k, v, p: _dense_attention(
                    q, k, v, p, p, causal=spec.causal), q, k, v, positions)
    if pad_heads:
        out = out[:, :, :n_q_orig, :]
    tap("attn_o", out, channel_axes=(-2, -1))
    y = _out_project(hint_heads(out), params["o"].to(dtype))
    return hint(y, "batch", "seq", "embed"), new_cache


def init_attention_cache(batch: int, s_max: int, spec: AttentionSpec,
                         dtype=torch.bfloat16, device=None) -> dict:
    shape = (batch, s_max, spec.n_kv, spec.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def init_paged_attention_cache(n_blocks: int, block_size: int,
                               spec: AttentionSpec, dtype=torch.bfloat16,
                               device=None) -> dict:
    """A paged KV arena: ``n_blocks`` fixed-size blocks shared by every
    sequence (the last block is the padding scratch block)."""
    shape = (n_blocks, block_size, spec.n_kv, spec.head_dim)
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
    """x: (..., d). Under a mesh on each rank's rows of ``x`` (d whole)
    and its slice of the hidden dim (the JAX package's ``ffn`` hint):
    the down-projection's partial sums are reduced where the output is
    laid out ``('batch', 'seq', 'embed')``."""
    dtype = x.dtype
    tap("mlp_in", x)

    def mlp(x, up_w, down_w, gate_w):
        up = x @ up_w
        if gate_w is not None:
            h = activation(spec.act, x @ gate_w) * up
        else:
            h = activation(spec.act, up)
        tap("mlp_down", h)
        return h @ down_w
    rows = (("batch", "residual_seq", None) if x.dim() == 3
            else ("batch",) + (None,) * (x.dim() - 1))
    up = params["up"].to(dtype)
    y = AX.on_shards(
        mlp, {0: rows, 1: (None, "ffn"), 2: ("ffn", None),
              3: (None, "ffn")}, (rows, x.shape), x, up,
        params["down"].to(dtype),
        params["gate"].to(dtype) if spec.gated else None,
        partial=AX.sharded_axes(up.shape, (None, "ffn")))
    return hint(y, "batch", "seq", "embed")
