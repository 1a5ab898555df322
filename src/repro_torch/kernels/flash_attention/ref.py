"""Plain PyTorch version of causal flash attention: dense causal GQA,
one masked f32 softmax over the whole sequence."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """q: (B, S, Hq, D); k, v: (B, S, Hkv, D) -> (B, S, Hq, D)."""
    B, S, n_q, D = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(B, S, n_kv, n_q // n_kv, D)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) \
        / math.sqrt(D)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(q.dtype))
    return out.reshape(B, S, n_q, D)
