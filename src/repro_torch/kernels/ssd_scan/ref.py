"""Plain PyTorch version of the Mamba-2 SSD chunked scan: the port of the
JAX package's ``models/ssm.py::ssd_chunked``, in the kernel's interface.

Within each chunk of ``Q = min(chunk, L)`` rows the output is the
attention-duality form ``((C Bᵀ) ∘ seg) xt`` with the causal segment
decay ``seg[i, j] = exp(Lc_i - Lc_j)`` (``Lc`` the chunk's cumulative
log-decay), plus the carried state read through ``C ∘ exp(Lc)``; a
Python loop over chunks carries the (H, P, N) state. A ragged tail is
padded with ``da = 0`` and zero rows, which changes no real output row
and not the final state. Roundings follow the JAX function: ``C Bᵀ``
and the state in f32, the masked scores and both output terms rounded
to ``xt``'s dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def ssd_chunked(xt: torch.Tensor, da: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int,
                h0: Optional[torch.Tensor] = None) -> tuple:
    """xt: (B, L, H, P) dt-scaled inputs; da: (B, L, H) log-decays
    (dt * A, <= 0); Bm, Cm: (B, L, N) (one group, shared by the heads);
    h0: optional (B, H, P, N) initial state. Returns y (B, L, H, P) in
    xt's dtype and the final state (B, H, P, N) in f32."""
    Bb, L0, H, P = xt.shape
    N = Bm.shape[-1]
    Q = min(chunk, L0)
    pad = (-L0) % Q
    if pad:
        xt = F.pad(xt, (0, 0, 0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    L = L0 + pad
    nc = L // Q
    f32 = torch.float32
    xt_c = xt.reshape(Bb, nc, Q, H, P)
    da_c = da.reshape(Bb, nc, Q, H).to(f32)
    B_c = Bm.reshape(Bb, nc, Q, N).to(f32)
    C_c = Cm.reshape(Bb, nc, Q, N).to(f32)

    Lc = torch.cumsum(da_c, dim=2)                            # (B,nc,Q,H)
    diff = Lc[:, :, :, None, :] - Lc[:, :, None, :, :]        # (B,nc,Q,Q,H)
    causal = torch.ones((Q, Q), dtype=torch.bool,
                        device=xt.device).tril()[None, None, :, :, None]
    # exp only where i >= j: above the diagonal diff can overflow
    seg = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                      0.0)
    CB = torch.einsum("bcin,bcjn->bcij", C_c, B_c)             # (B,nc,Q,Q)
    scores = (CB[..., None] * seg).to(xt.dtype)                # (B,nc,Q,Q,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", scores, xt_c)

    decay_end = torch.exp(Lc[:, :, -1:, :] - Lc)               # (B,nc,Q,H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_end, B_c,
                          xt_c.to(f32))                        # (B,nc,H,P,N)
    chunk_decay = torch.exp(Lc[:, :, -1, :])                   # (B,nc,H)
    h = (torch.zeros((Bb, H, P, N), dtype=f32, device=xt.device)
         if h0 is None else h0.to(f32))
    h_prev = []
    for c in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)                        # (B,nc,H,P,N)
    y_inter = torch.einsum("bcin,bchpn,bcih->bcihp", C_c, h_prev,
                           torch.exp(Lc)).to(xt.dtype)
    y = (y_intra + y_inter).reshape(Bb, L, H, P)
    return y[:, :L0], h
