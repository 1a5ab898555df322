"""Plain PyTorch version of paged decode attention: the serving gather
path, standalone. Each sequence's logical KV view is gathered through
its block table, then one masked f32 softmax runs over the whole view."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def paged_attention_ref(q: torch.Tensor, k_arena: torch.Tensor,
                        v_arena: torch.Tensor, block_tables: torch.Tensor,
                        lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, n_q, D); arenas (n_blocks + 1, bs, n_kv, D); block_tables
    (B, max_blocks); lengths (B,). Returns (B, n_q, D)."""
    B, n_q, D = q.shape
    bs, n_kv = k_arena.shape[1], k_arena.shape[2]
    M = block_tables.shape[1]
    group = n_q // n_kv
    scale = 1.0 / math.sqrt(D)
    rows = (block_tables.long()[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :])
    rows = rows.reshape(B, M * bs)

    def view(arena):
        return arena.reshape(-1, n_kv, D)[rows]          # (B, M*bs, nkv, D)

    k, v = view(k_arena), view(v_arena)
    qg = q.reshape(B, n_kv, group, D)
    logits = torch.einsum("bkgd,btkd->bkgt", qg.float(), k.float()) * scale
    valid = (torch.arange(M * bs, device=q.device)[None, :]
             < lengths[:, None])
    logits = torch.where(valid[:, None, None, :], logits,
                         torch.full((), NEG_INF, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bkgt,btkd->bkgd", probs, v.to(q.dtype))
    return out.reshape(B, n_q, D)
