"""Plain float32 reference of the served model, for the check that
decides ``correct``.

It follows the configuration as the benchmark states it (the published
architecture, with the departures its file lists), from the tensors the
benchmark made (``modelgen``), and imports nothing of the program: no
kernel, cache, paging, batching or plan. One causal forward over a whole
sequence (prompt and served tokens) gives the logits at every position;
the served model's chunked, paged and batched steps must agree with it.

The only serving rule it takes over is the MoE capacity, which changes
the mathematics: each call's tokens form one routing group per sequence,
a group keeps at most ``capacity(tokens)`` assignments per expert in
token order, and the rest are dropped. The configuration's serving
section states the calls: prompts enter in chunks of ``prefill_chunk``
tokens right-padded to a multiple of ``prefill_multiple`` (padding sits
after the real tokens, so it never displaces one), and every decode
step is a group of one token.

Matmuls run in float32 with TF32 off. ``quant="fp8"`` computes every
matmul's operands in float8 e4m3 (per-column weight and per-row
activation scales): the lower-precision control.
"""
from __future__ import annotations

import math

import torch

FP8_MAX = 448.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    amax = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    s = amax / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def _mm(x: torch.Tensor, w: torch.Tensor, quant: str) -> torch.Tensor:
    """x (R, K) @ w (K, N) in f32, or on fp8-rounded operands."""
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, 0)
    return x @ w


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * scale.float()


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (S, H, D), positions 0..S-1; rotate-half layout."""
    S, _, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float64,
                                        device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _attention(q, k, v, q_block: int = 512) -> torch.Tensor:
    """Causal GQA attention. q (S, Hq, D), k/v (S, Hkv, D) -> (S, Hq, D)."""
    S, Hq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    kk = k.permute(1, 0, 2)                              # (Hkv, S, D)
    vv = v.permute(1, 0, 2)
    out = torch.empty_like(q)
    pos = torch.arange(S, device=q.device)
    for s0 in range(0, S, q_block):
        qb = q[s0:s0 + q_block].reshape(-1, Hkv, g, D).permute(1, 2, 0, 3)
        sc = torch.einsum("hgsd,htd->hgst", qb, kk) / math.sqrt(D)
        mask = pos[None, :] <= pos[s0:s0 + q_block, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        o = torch.einsum("hgst,htd->hgsd", torch.softmax(sc, dim=-1), vv)
        out[s0:s0 + q_block] = o.permute(2, 0, 1, 3).reshape(-1, Hq, D)
    return out


def capacity(n_tokens: int, moe: dict) -> int:
    """Per-expert slots of a routing group of ``n_tokens`` tokens: the
    stated capacity factor times the group's assignments over the
    experts, at least 4 and a multiple of 4."""
    c = max(1, int(math.ceil(moe["capacity_factor"] * moe["top_k"]
                             * n_tokens / moe["n_experts"])))
    return max(4, ((c + 3) // 4) * 4)


def routing_groups(prompt_len: int, total: int, serving: dict) -> list:
    """(start, end, capacity tokens) of each routing group of a sequence
    of ``total`` tokens whose first ``prompt_len`` are its prompt: one
    per prefill chunk (counted at its padded length), one per decode
    token."""
    out = []
    chunk, mult = serving["prefill_chunk"], serving["prefill_multiple"]
    for s in range(0, prompt_len, chunk):
        e = min(s + chunk, prompt_len)
        out.append((s, e, -(-(e - s) // mult) * mult))
    out += [(t, t + 1, 1) for t in range(prompt_len, total)]
    return out


def _moe(h: torch.Tensor, p: dict, moe: dict, groups: list,
         quant: str) -> torch.Tensor:
    """Top-k MoE over rows ``h`` (R, d): softmax router, top-k, gates
    renormalised, per-group capacity drops in token order."""
    E, K = moe["n_experts"], moe["top_k"]
    logits = _mm(h, p["router"].float(), quant)
    probs = torch.softmax(logits, dim=-1)
    gates, ids = torch.topk(probs, K, dim=-1)            # (R, K)
    if moe["norm_topk_prob"]:
        gates = gates / gates.sum(-1, keepdim=True)
    keep = torch.ones_like(ids, dtype=torch.bool)
    for s, e, n_cap in groups:
        if e - s == 1:
            continue        # one token's experts are distinct: no drop
        flat = ids[s:e].reshape(-1)
        onehot = torch.nn.functional.one_hot(flat, E)
        pos = (onehot.cumsum(0) * onehot).sum(-1) - 1
        keep[s:e] = (pos < capacity(n_cap, moe)).reshape(e - s, K)
    y = torch.zeros_like(h)
    rows = torch.arange(h.shape[0], device=h.device)[:, None].expand(-1, K)
    sel = keep.reshape(-1)
    r_all, e_all = rows.reshape(-1)[sel], ids.reshape(-1)[sel]
    g_all = gates.reshape(-1)[sel]
    order = torch.argsort(e_all, stable=True)
    r_all, e_all, g_all = r_all[order], e_all[order], g_all[order]
    counts = torch.bincount(e_all, minlength=E).tolist()
    start = 0
    for e, n in enumerate(counts):
        if n == 0:
            continue
        r = r_all[start:start + n]
        xe = h[r]
        a = torch.nn.functional.silu(_mm(xe, p["gate"][e].float(), quant))
        out = _mm(a * _mm(xe, p["up"][e].float(), quant),
                  p["down"][e].float(), quant)
        y.index_add_(0, r, out * g_all[start:start + n, None])
        start += n
    return y


@torch.no_grad()
def logits(desc: dict, params: dict, seqs: list, serving: dict,
           quant: str = "none") -> list:
    """Float32 logits of each ``(tokens, prompt_len)`` in ``seqs`` at the
    positions that predict its served tokens (rows ``prompt_len - 1``
    on, ``(S_i - prompt_len + 1, vocab)``): one causal forward per
    sequence, run layer by layer over all of them, each layer's weights
    cast to f32 once."""
    no_tf32()
    d, V = desc["d_model"], desc["vocab"]
    eps, theta = desc["norm_eps"], desc["rope_theta"]
    dev = params["embed"]["table"].device
    toks = [torch.as_tensor(t, dtype=torch.long, device=dev) for t, _ in seqs]
    xs = [params["embed"]["table"][t].float() for t in toks]
    groups, base = [], 0
    for (t, plen), x in zip(seqs, xs):
        groups += [(s + base, e + base, n) for s, e, n in
                   routing_groups(plen, len(t), serving)]
        base += len(t)
    hd, n_kv = desc["head_dim"], desc["n_kv"]
    for i, L in enumerate(desc["layers"]):
        blk = params["blocks"][i]
        a = blk["attn"]
        wq = a["q"].float().reshape(d, -1)
        wk = a["k"].float().reshape(d, -1)
        wv = a["v"].float().reshape(d, -1)
        wo = a["o"].float().reshape(-1, d)
        for j, x in enumerate(xs):
            h = _rms(x, blk["norm1"]["scale"], eps)
            S = h.shape[0]
            q = _rope(_mm(h, wq, quant).view(S, L["n_q"], hd), theta)
            k = _rope(_mm(h, wk, quant).view(S, n_kv, hd), theta)
            v = _mm(h, wv, quant).view(S, n_kv, hd)
            xs[j] = x + _mm(_attention(q, k, v).reshape(S, -1), wo, quant)
        del wq, wk, wv, wo
        h = torch.cat([_rms(x, blk["norm2"]["scale"], eps) for x in xs])
        if desc["moe"] is None:
            m = blk["mlp"]
            gt = torch.nn.functional.silu(_mm(h, m["gate"].float(), quant))
            y = _mm(gt * _mm(h, m["up"].float(), quant), m["down"].float(),
                    quant)
        else:
            y = _moe(h, blk["moe"], desc["moe"], groups, quant)
        off = 0
        for j, x in enumerate(xs):
            xs[j] = x + y[off:off + x.shape[0]]
            off += x.shape[0]
        del h, y
    head = params["lm_head"]["w"][:, :V].float()
    return [_mm(_rms(x[plen - 1:], params["final_norm"]["scale"], eps),
                head, quant) for x, (_, plen) in zip(xs, seqs)]
