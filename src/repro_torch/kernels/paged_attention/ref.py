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


def paged_attention_partitioned_ref(q: torch.Tensor, k_arena: torch.Tensor,
                                    v_arena: torch.Tensor,
                                    block_tables: torch.Tensor,
                                    lengths: torch.Tensor,
                                    part_blocks: int) -> torch.Tensor:
    """The CUDA kernel's partition-and-merge arithmetic, in plain f32
    torch. Each row's view is cut into partitions of ``part_blocks``
    whole blocks; each live partition p (partition 0 always) takes one
    softmax of its own, m_p = max s, l_p = sum exp(s - m_p), acc_p =
    sum exp(s - m_p) v; the live partitions are merged, out =
    sum_p w_p acc_p / max(sum_p w_p l_p, 1e-30), w_p = exp(m_p - max m).
    Only the tests use it, to hold that arithmetic to the JAX package on
    the CPU; the CPU path serves through ``paged_attention_ref``."""
    B, n_q, D = q.shape
    bs, n_kv = k_arena.shape[1], k_arena.shape[2]
    M = block_tables.shape[1]
    group = n_q // n_kv
    P = part_blocks * bs
    n_parts = -(-M // part_blocks)
    tables = torch.nn.functional.pad(block_tables.long(),
                                     (0, n_parts * part_blocks - M))
    rows = (tables[:, :, None] * bs
            + torch.arange(bs, device=q.device)[None, None, :])
    rows = rows.reshape(B, n_parts, P)

    def view(arena):                      # (B, n_parts, P, n_kv, D)
        return arena.reshape(-1, n_kv, D)[rows].float()

    k, v = view(k_arena), view(v_arena)
    qg = q.float().reshape(B, n_kv, group, D) / math.sqrt(D)
    s = torch.einsum("bkgd,bptkd->bkgpt", qg, k)
    length = lengths.long().clamp(0, M * bs)
    pos = torch.arange(n_parts * P, device=q.device).reshape(n_parts, P)
    valid = (pos[None] < length[:, None, None])[:, None, None]
    s = torch.where(valid, s, torch.full((), NEG_INF, device=q.device))
    m = s.amax(-1)                                   # (B, n_kv, G, n_parts)
    e = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros((), device=q.device))
    acc = torch.einsum("bkgpt,bptkd->bkgpd", e, v)
    live = (pos[None, :, 0] < length[:, None]) | (
        torch.arange(n_parts, device=q.device)[None] == 0)
    live = live[:, None, None, :]
    mx = torch.where(live, m, torch.full((), NEG_INF, device=q.device)
                     ).amax(-1, keepdim=True)
    w = torch.where(live, torch.exp(m - mx), torch.zeros((), device=q.device))
    num = (acc * w[..., None]).sum(-2)
    den = (e.sum(-1) * w).sum(-1).clamp_min(1e-30)
    return (num / den[..., None]).reshape(B, n_q, D).to(q.dtype)
