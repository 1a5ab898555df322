"""The benchmark's own pruned model: shapes, targets, masks and weights
from a configuration file and ``--seed``.

It makes the model Mosaic's composite pruning leaves behind, without
running the prune pipeline (which would make set-up long and would give
the reference ranks to redo):

- per-projection targets around the recipe's ``p``: layer targets spread
  by ``spread`` and projection targets within a layer by
  ``within_spread``, each set re-centred so the means are exact;
- structured removal at ``structured_share`` of those targets: q heads
  removed equally per kv group (kv heads kept), feed-forward and expert
  channels kept in multiples of ``align_channels``;
- ``block`` x ``block`` masks at each projection's remaining density,
  with the same number of live blocks in every column of blocks;
- normal weights at the port's initial scales, drawn on the device in
  one call per layer, in the dtype they are served in.

Plain torch and numpy only: the reference reads the same description
and the same tensors. The params tree is laid out as the port takes it
(``repro_torch.models.transformer.init_model``'s layout).
"""
from __future__ import annotations

import math

import numpy as np
import torch

ATTN = ("q", "k", "v", "o")
FFN = ("gate", "up", "down")
MASK = (1 << 64) - 1


def _centred(rng: np.random.Generator, n: int, mean: float,
             spread: float) -> np.ndarray:
    """``n`` values with mean exactly ``mean`` and the largest deviation
    ``spread * mean`` (the planner's shape without its ranks)."""
    u = rng.uniform(-1.0, 1.0, n)
    dev = u - u.mean()
    top = np.abs(dev).max()
    if n == 1 or top == 0:
        return np.full(n, mean)
    return mean + spread * mean * dev / top


def aligned_keep(total: int, frac: float, align: int, min_keep: int) -> int:
    """Groups kept after removing ``frac`` of ``total``: a multiple of
    ``align`` and at least ``min_keep`` (the recipe's alignment rule)."""
    keep = total - int(round(frac * total))
    keep = max(min_keep, keep)
    if align > 1:
        keep = max(align, int(round(keep / align)) * align)
    return min(keep, total)


def describe(conf: dict, seed: int) -> dict:
    """Shapes and per-projection live-block counts of the pruned model.
    Deterministic in ``seed``; JSON-safe."""
    pr = conf["pruning"]
    d = conf["hidden_size"]
    n_q = conf["num_attention_heads"]
    n_kv = conf["num_key_value_heads"]
    hd = conf.get("head_dim") or d // n_q
    n_layers = conf["num_hidden_layers"]
    moe = "num_experts" in conf
    d_ff = conf["moe_intermediate_size"] if moe else conf["intermediate_size"]
    b = pr["block"]
    rng = np.random.default_rng([seed & MASK, 0x7A46E7])
    p = pr["p"]
    layer_t = _centred(rng, n_layers, p, pr["spread"])
    layers = []
    for i in range(n_layers):
        t = dict(zip(ATTN + FFN,
                     _centred(rng, 7, layer_t[i], pr["within_spread"])))
        share = pr["structured_share"]
        g = n_q // n_kv
        f_heads = share * float(np.mean([t[n] for n in ATTN]))
        keep_g = aligned_keep(g, f_heads, 1, 1)
        f_ffn = share * float(np.mean([t[n] for n in FFN]))
        a = pr["align_channels"]
        ff = aligned_keep(d_ff, f_ffn, a, min(a, d_ff))
        kept = {"q": keep_g / g, "o": keep_g / g, "k": 1.0, "v": 1.0,
                "gate": ff / d_ff, "up": ff / d_ff, "down": ff / d_ff}
        nq = keep_g * n_kv
        fold = {"q": (d, nq * hd), "k": (d, n_kv * hd), "v": (d, n_kv * hd),
                "o": (nq * hd, d), "gate": (d, ff), "up": (d, ff),
                "down": (ff, d)}
        live = {}
        for name, (K, N) in fold.items():
            density = min(1.0, (1.0 - t[name]) / kept[name])
            nK = K // b
            live[name] = max(1, min(nK, int(round(density * nK))))
        layers.append({"n_q": nq, "d_ff": ff, "targets": t,
                       "live_per_col": live,
                       "fold": {k: list(v) for k, v in fold.items()}})
    pad = conf["serving"]["vocab_pad_multiple"]
    desc = {
        "name": conf["name"], "d_model": d, "vocab": conf["vocab_size"],
        "vocab_pad_multiple": pad,
        "padded_vocab": -(-conf["vocab_size"] // pad) * pad,
        "n_kv": n_kv, "head_dim": hd, "n_q_published": n_q,
        "rope_theta": float(conf["rope_theta"]),
        "norm_eps": float(conf.get("reference_follows", {}).get(
            "rms_norm_eps", conf["rms_norm_eps"])), "block": b,
        "act": conf["hidden_act"], "layers": layers, "moe": None,
    }
    if moe:
        desc["moe"] = {"n_experts": conf["num_experts"],
                       "top_k": conf["num_experts_per_tok"],
                       "capacity_factor": conf["serving"]["capacity_factor"],
                       "norm_topk_prob": bool(conf["norm_topk_prob"])}
    return desc


def _leaf_shapes(desc: dict, i: int) -> list:
    """(path-in-block, shape, std) of layer ``i``'s weights, in draw
    order."""
    L = desc["layers"][i]
    d, hd, n_kv, nq, ff = (desc["d_model"], desc["head_dim"], desc["n_kv"],
                           L["n_q"], L["d_ff"])
    out = [(("attn", "q"), (d, nq, hd), d ** -0.5),
           (("attn", "k"), (d, n_kv, hd), d ** -0.5),
           (("attn", "v"), (d, n_kv, hd), d ** -0.5),
           (("attn", "o"), (nq, hd, d), (nq * hd) ** -0.5)]
    if desc["moe"] is None:
        out += [(("mlp", "gate"), (d, ff), d ** -0.5),
                (("mlp", "up"), (d, ff), d ** -0.5),
                (("mlp", "down"), (ff, d), ff ** -0.5)]
    else:
        E = desc["moe"]["n_experts"]
        out += [(("moe", "router"), (d, E), d ** -0.5),
                (("moe", "gate"), (E, d, ff), d ** -0.5),
                (("moe", "up"), (E, d, ff), d ** -0.5),
                (("moe", "down"), (E, ff, d), ff ** -0.5)]
    return out


def _mask_(w3: torch.Tensor, live: int, b: int,
           gen: torch.Generator) -> None:
    """Zero all but ``live`` random ``b`` x ``b`` blocks in every column of
    blocks of each ``(K, N)`` matrix of the ``(E, K, N)`` view ``w3``, in
    place."""
    E, K, N = w3.shape
    nK, nN = K // b, N // b
    if live >= nK:
        return
    score = torch.rand((E, nK, nN), generator=gen, device=w3.device)
    keep = torch.zeros((E, nK, nN), dtype=w3.dtype, device=w3.device)
    keep.scatter_(1, score.topk(live, dim=1).indices, 1)
    w3.view(E, nK, b, nN, b).mul_(keep[:, :, None, :, None])


def generate(desc: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The params tree on ``device``: each layer's weights drawn in one
    call into one buffer and masked in place; embedding and head in one
    more. Norm scales are ones."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed((seed & MASK) ^ 0x5EED0FB1)
    d, Vp = desc["d_model"], desc["padded_vocab"]
    ones = lambda: torch.ones((d,), dtype=dtype, device=dev)  # noqa: E731
    big = torch.randn((2 * Vp * d,), generator=gen, device=dev, dtype=dtype)
    params = {"embed": {"table": big[:Vp * d].view(Vp, d).mul_(0.02)},
              "lm_head": {"w": big[Vp * d:].view(d, Vp).mul_(d ** -0.5)},
              "final_norm": {"scale": ones()}, "blocks": []}
    for i, L in enumerate(desc["layers"]):
        leaves = _leaf_shapes(desc, i)
        total = sum(math.prod(s) for _, s, _ in leaves)
        buf = torch.randn((total,), generator=gen, device=dev, dtype=dtype)
        block = {"norm1": {"scale": ones()}, "norm2": {"scale": ones()}}
        off = 0
        for (group, name), shape, std in leaves:
            n = math.prod(shape)
            w = buf[off:off + n].view(shape).mul_(std)
            off += n
            if name in L["live_per_col"]:
                K, N = L["fold"][name]
                _mask_(w.view(-1, K, N), L["live_per_col"][name],
                       desc["block"], gen)
            block.setdefault(group, {})[name] = w
        params["blocks"].append(block)
    return params
