"""Mamba-2 (SSD, state-space duality) mixer.

y_t = C_t · h_t,   h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T

The port of ``repro/models/ssm.py``. A multi-token call computes the
recurrence chunk-wise (arXiv:2405.21060): a quadratic attention-like
intra-chunk term plus a linear inter-chunk state recurrence, through
``kernels/ssd_scan`` — the CUDA kernel on CUDA tensors, its plain version
(``kernels/ssd_scan/ref.py::ssd_chunked``) on CPU tensors, and on any
device with ``train`` (set by ``transformer.loss_fn``: the plain scan is
the path the reference trains on, and the kernel has no backward pass).
A single decode step (``L == 1`` with a cache) runs the recurrence
itself in plain torch, as the JAX package does.
The cache ``{'conv': (B, K-1, conv_dim), 'state': (B, H, P, N) f32}`` is
updated in place and also returned.

Under an active mesh the JAX package's sharding hints take effect on
the projections, and the rest runs on each rank's local shards: the
convolution and the gates, and the gated norm, on its batch rows (the
channels whole); the chunked scan (kernel 10 on CUDA shards) and the
decode recurrence on its batch rows and SSD heads, heads over 'model'
where they divide it, as the JAX package hints them. Batch rows and
heads are independent in all of these. With no mesh every hint is a
no-op and ``on_shards`` calls the function as it is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import axes as AX
from repro_torch.distributed.axes import hint
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.models.layers import _randn, gen_device
from repro_torch.models.specs import MambaSpec
from repro_torch.models.taps import tap

# leaves the JAX package keeps in f32 whatever the model's dtype
F32_LEAVES = ("A_log", "D", "dt_bias")
NORM_EPS = 1e-6


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log1p(exp(-|x|)) + max(x, 0)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp(min=0)


def init_mamba(gen: Optional[torch.Generator], d_model: int,
               spec: MambaSpec, dtype=torch.float32) -> dict:
    """Params on ``gen``'s device (``meta`` when ``gen`` is None). As in
    the JAX package, ``A_log`` and ``dt_bias`` come from one uniform draw
    (``dt`` log-uniform in [1e-3, 0.1], ``dt_bias`` its softplus inverse;
    ``A = -(1 + 15 u)``)."""
    s_in = 1.0 / math.sqrt(d_model)
    s_out = 1.0 / math.sqrt(spec.d_inner)
    H = spec.n_heads
    dev = gen_device(gen)
    p = {
        "in_proj": _randn(gen, (d_model, spec.in_dim), s_in, dtype),
        "conv_w": _randn(gen, (spec.conv_dim, spec.d_conv),
                         1.0 / math.sqrt(spec.d_conv), dtype),
        "conv_b": torch.zeros((spec.conv_dim,), dtype=dtype, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((spec.d_inner,), dtype=dtype, device=dev),
        "out_proj": _randn(gen, (spec.d_inner, d_model), s_out, dtype),
    }
    if gen is None:
        p["A_log"] = torch.empty((H,), device="meta")
        p["dt_bias"] = torch.empty((H,), device="meta")
        return p
    u = torch.rand((H,), generator=gen, device=dev)
    dt = torch.exp(u * (math.log(0.1) - math.log(1e-3)) + math.log(1e-3))
    p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
    p["A_log"] = torch.log(1.0 + u * 15.0)
    return p


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 carry: Optional[torch.Tensor] = None) -> tuple:
    """Depthwise causal conv1d. xbc: (B, L, C), w: (C, K), carry: the
    last K-1 inputs (B, K-1, C) or None (zeros). Returns (out, new
    carry); mixed dtypes promote as ``jnp.concatenate`` does."""
    B, L, C = xbc.shape
    K = w.shape[1]
    if carry is None:
        carry = torch.zeros((B, K - 1, C), dtype=xbc.dtype,
                            device=xbc.device)
    full = torch.cat([carry, xbc], dim=1)                  # (B, L+K-1, C)
    out = torch.zeros((B, L, C), dtype=xbc.dtype, device=xbc.device)
    for k in range(K):
        out = out + full[:, k:k + L, :] * w[:, k].to(xbc.dtype)
    return out + b.to(xbc.dtype), full[:, L:, :]


def ssd_step(h: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """One decode step of the recurrence on the state ``h`` (B, H, P, N)
    f32, in place: ``h <- h * exp(da) + B xt^T``; returns ``C · h`` (B,
    H, P) in f32. da: (B, H); Bm, Cm: (B, N); xt: (B, H, P)."""
    upd = torch.einsum("bn,bhp->bhpn", Bm.float(), xt.float())
    h.mul_(torch.exp(da)[:, :, None, None]).add_(upd)
    return torch.einsum("bn,bhpn->bhp", Cm.float(), h)


def _assign(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a sharded ``dst`` is written shard by shard,
    ``src`` laid out as ``dst`` first."""
    if AX.is_dtensor(dst):
        src = AX.to_placements(src, dst.device_mesh, AX.placements_spec(dst))
        dst, src = dst.to_local(), src.to_local()
    dst.copy_(src)


def apply_mamba(params: dict, spec: MambaSpec, x: torch.Tensor,
                cache: Optional[dict] = None, train: bool = False) -> tuple:
    """x: (B, L, d_model). cache: {'conv': (B, K-1, conv_dim), 'state':
    (B, H, P, N) f32}, updated in place. ``train``: the chunked scan's
    plain version on any device. Returns (out, new_cache)."""
    dtype = x.dtype
    B, L, _ = x.shape
    H, P, N = spec.n_heads, spec.head_dim, spec.d_state
    di = spec.d_inner

    tap("mamba_in", x)
    # the projections on each rank's rows and its slice of the projected
    # dim (the JAX package's "inner" hint), the embed dim gathered whole
    rows, rows4 = ("batch", None, None), ("batch", None, None, None)
    w_in = params["in_proj"].to(dtype)
    zxbcdt = AX.on_shards(lambda x, w: x @ w, {0: rows, 1: (None, "inner")},
                          (("batch", None, "inner"), (B, L, w_in.shape[1])),
                          x, w_in)                         # (B, L, in_dim)

    def mix_in(zxbcdt, conv_w, conv_b, dt_bias, A_log, carry):
        Bl = zxbcdt.shape[0]
        z = zxbcdt[..., :di]
        xbc = zxbcdt[..., di:di + spec.conv_dim]
        dt_raw = zxbcdt[..., di + spec.conv_dim:]          # (B, L, H)
        xbc, new_conv = _causal_conv(xbc, conv_w, conv_b, carry)
        xbc = F.silu(xbc)
        xs = xbc[..., :di].reshape(Bl, L, H, P)
        Bm = xbc[..., di:di + N]                           # (B, L, N)
        Cm = xbc[..., di + N:di + 2 * N]
        dt = _softplus(dt_raw.float() + dt_bias.float())
        # exp in the leaf's dtype, as the JAX package does (bf16 when a
        # train step casts every leaf; the engines keep A_log in f32)
        A = -torch.exp(A_log).float()                      # (H,) < 0
        da = dt * A                                        # (B, L, H)
        xt = xs * dt[..., None].to(dtype)
        return z, xs, Bm, Cm, da, xt, new_conv

    # the conv and the gates on each rank's batch rows, channels whole
    K = params["conv_w"].shape[1]
    z, xs, Bm, Cm, da, xt, new_conv = AX.on_shards(
        mix_in, {0: rows, 5: rows},
        [(rows, (B, L, di)), (rows4, (B, L, H, P)), (rows, (B, L, N)),
         (rows, (B, L, N)), (rows, (B, L, H)), (rows4, (B, L, H, P)),
         (rows, (B, K - 1, spec.conv_dim))],
        zxbcdt, params["conv_w"], params["conv_b"], params["dt_bias"],
        params["A_log"], cache["conv"] if cache is not None else None)

    # the recurrence on each rank's batch rows and SSD heads
    if cache is not None and L == 1:
        y, new_state = AX.on_shards(
            lambda h, da, Bm, Cm, xt: (ssd_step(h, da, Bm, Cm, xt), h),
            {0: ("batch", "heads", None, None), 1: ("batch", "heads"),
             2: ("batch", None), 3: ("batch", None),
             4: ("batch", "heads", None)},
            [(("batch", "heads", None), (B, H, P)),
             (("batch", "heads", None, None), (B, H, P, N))],
            cache["state"], da[:, 0], Bm[:, 0], Cm[:, 0], xt[:, 0])
        y = y[:, None].to(dtype)                           # (B, 1, H, P)
    else:
        scan = ssd_ref.ssd_chunked if train else ssd_ops.ssd_scan
        seq = ("batch", None, "heads", None)
        y, new_state = AX.on_shards(
            lambda xt, da, Bm, Cm, h0: scan(xt, da, Bm, Cm, spec.chunk, h0),
            {0: seq, 1: seq[:3], 2: rows, 3: rows,
             4: ("batch", "heads", None, None)},
            [(seq, xt.shape), (("batch", "heads", None, None), (B, H, P, N))],
            xt, da, Bm, Cm, cache["state"] if cache is not None else None)
    if cache is not None:
        _assign(cache["state"], new_state)

    def mix_out(y, xs, z, D, norm_scale):
        y = y + D.to(dtype)[None, None, :, None] * xs
        y = y.reshape(*z.shape)
        # gated RMSNorm
        y = y * F.silu(z)
        var = y.float().square().mean(dim=-1, keepdim=True)
        y = (y.float() * torch.rsqrt(var + NORM_EPS)).to(dtype)
        return y * norm_scale.to(dtype)
    y = AX.on_shards(mix_out, {0: rows4, 1: rows4, 2: rows},
                     (rows, (B, L, di)), y, xs, z, params["D"],
                     params["norm_scale"])
    tap("mamba_out", y)
    w_out = params["out_proj"].to(dtype)
    out = AX.on_shards(lambda y, w: y @ w, {0: ("batch", None, "inner"),
                                           1: ("inner", None)},
                       (rows, (B, L, w_out.shape[1])), y, w_out,
                       partial=AX.sharded_axes(w_out.shape, ("inner", None)))
    out = hint(out, "batch", "seq", "embed")

    if cache is None:
        return out, None
    _assign(cache["conv"], new_conv)
    return out, cache


def init_mamba_cache(batch: int, spec: MambaSpec, dtype=torch.bfloat16,
                     device=None) -> dict:
    """Conv carry in the cache dtype, SSD state in f32."""
    return {
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.conv_dim),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, spec.n_heads, spec.head_dim,
                              spec.d_state), dtype=torch.float32,
                             device=device),
    }
