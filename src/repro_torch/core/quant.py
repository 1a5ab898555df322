"""Weight-only quantisation: the RTN baseline plus the per-tile int8
helpers behind the sparse x quantized serving path.

The port's counterpart of ``repro/core/quant.py``.
``quantize_array``/``quantize_model`` implement group-wise symmetric
round-to-nearest int{8,4,3,2}: each output column quantises in groups of
consecutive *input* rows, so groups never straddle output columns (the
GPTQ/RTN convention). The dequantised model runs through the normal
dense forward.

``quantize_tiles``/``dequantize_tiles`` quantise the *kept* tiles of a
block-sparse plan to int8 with one symmetric power-of-two scale per
tile. A power-of-two scale only shifts exponents and ``|q| <= 127`` fits
every mantissa, so a dequantised weight ``float(q) * scale`` is exact in
f32 and in bf16: a kernel that dequantises its int8 tiles on load
computes bitwise what the unquantized kernel computes over the
dequantised weight.

The scale exponent is the JAX package's numpy expression, run on the
host over the tiles' ``amax`` (one float per tile): a device ``log2``
or an exact ``frexp`` can pick the other exponent when ``amax / 127``
lies a few ulps above a power of two. Everything else (the ``amax``,
the rounding of ``q``) runs on the tiles' device.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.tree import tree_get, tree_set
from repro_torch.core.recipe import QUANT_MODES  # noqa: F401  (as in JAX)
from repro_torch.core.registry import projections
from repro_torch.models.specs import ModelConfig

INT8_MAXQ = 127


def quantize_array(w: torch.Tensor, bits: int, group: int = 128):
    """Group-wise symmetric RTN. The weight folds to ``(K, N)`` (input
    rows x flattened outputs); each output column quantises in groups of
    ``group`` consecutive input rows. Returns ``(q, scale, orig_shape,
    pad)``: ``q`` is ``(N, ceil(K/group), group)`` int8, ``scale``
    broadcasts against it. Invert with :func:`dequantize_array`."""
    orig_shape = tuple(w.shape)
    w2 = w.float().reshape(w.shape[0], -1)                     # (K, N)
    pad = (-w2.shape[0]) % group
    cols = torch.nn.functional.pad(w2, (0, 0, 0, pad)).T       # (N, K+pad)
    g = cols.reshape(cols.shape[0], -1, group)
    maxq = 2 ** (bits - 1) - 1
    scale = g.abs().amax(dim=-1, keepdim=True) / maxq
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(g / scale), -maxq - 1, maxq).to(torch.int8)
    return q, scale, orig_shape, pad


def dequantize_array(q: torch.Tensor, scale: torch.Tensor, orig_shape,
                     pad: int) -> torch.Tensor:
    cols = (q.float() * scale).reshape(q.shape[0], -1)
    if pad:
        cols = cols[:, :-pad]
    return cols.T.reshape(orig_shape)


def quantize_model(params, cfg: ModelConfig, bits: int, group: int = 128):
    """Fake-quant every projection (round trip). Returns (params, stats)."""
    cfg = cfg if not cfg.scan_layers else cfg.unrolled()
    dense_bits = 0
    quant_bits = 0
    for proj in projections(cfg):
        w = tree_get(params, proj.path)
        q, scale, shape, pad = quantize_array(w, bits, group)
        dense_bits += w.numel() * 16                       # fp16 reference
        quant_bits += w.numel() * bits + scale.numel() * 16
        params = tree_set(params, proj.path,
                          dequantize_array(q, scale, shape, pad).to(w.dtype))
    stats = {"compression": dense_bits / max(quant_bits, 1), "bits": bits}
    return params, stats


# ------------------------------------------------------------ kept tiles


def pow2_scales(amax: np.ndarray) -> np.ndarray:
    """Per-tile scales ``2^ceil(log2(amax / 127))`` (1.0 for an all-zero
    tile), clipped to 2^+-126: the JAX package's numpy expression, on the
    host, so both packages pick the same exponent bit for bit."""
    amax = np.asarray(amax, np.float32)
    exp = np.ceil(np.log2(np.maximum(amax, 1e-38) / INT8_MAXQ))
    return np.where(amax > 0, np.exp2(np.clip(exp, -126, 126)),
                    1.0).astype(np.float32)


def quantize_tiles(tiles: torch.Tensor) -> tuple:
    """Symmetric int8 with one power-of-two scale per tile. ``tiles``:
    (T, bk, bn) float on any device. Returns ``(q, scales)`` on that
    device: ``q`` (T, bk, bn) int8, ``scales`` (T,) f32. Only the (T,)
    ``amax`` goes to the host and only the scales come back."""
    t = tiles.float()
    amax = t.abs().amax(dim=(1, 2)).cpu().numpy()
    scales = torch.from_numpy(pow2_scales(amax)).to(t.device)
    q = torch.clamp(torch.round(t / scales[:, None, None]), -INT8_MAXQ,
                    INT8_MAXQ).to(torch.int8)
    return q, scales


def dequantize_tiles(q: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Exact inverse of the pow2 fake-quant: (T, bk, bn) f32 tiles."""
    return q.float() * scales.float()[:, None, None]
