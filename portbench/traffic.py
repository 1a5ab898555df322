"""The general traffic generator: a traffic file of parameters in, the
requests of every client out.

A traffic file (``traffic/<name>.json``) states a closed loop: a number
of clients, each with one request in flight, sending its next request
when the last one finishes; the engine's slots and per-sequence length;
and the prompt and output length distributions. Every seed gets the same
set of sizes: round ``r`` of the clients draws its prompt lengths at the
``clients`` evenly spaced quantiles of the prompt distribution and its
output lengths at those of the output distribution, and the seed only
permutes which client gets which length and chooses the token ids. So
runs on different seeds do the same work in another order.

``"first_wave": "residual"`` starts the loop as if it had been running:
the first round's outputs are cut to residuals, each output quantile
paired with a fraction ``(k + 0.5) / clients`` of itself by a fixed
scramble, so the first requests finish at spread times and slots are
refilled from the window's start, as in a loop that had run for a while.
"""
from __future__ import annotations

import math

import numpy as np

MASK = (1 << 64) - 1


def quantiles(dist: dict, n: int) -> list:
    """``n`` lengths at the quantiles ``(i + 0.5) / n`` of ``dist``:
    ``{"dist": "loguniform" | "uniform", "min", "max"}`` (inclusive,
    whole tokens)."""
    lo, hi = dist["min"], dist["max"]
    u = (np.arange(n) + 0.5) / n
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        v = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown distribution {dist['dist']!r}")
    return [int(min(hi, max(lo, round(x)))) for x in v]


def clients(traffic: dict, seed: int, vocab: int) -> list:
    """Per client, its requests in order: ``(prompt ids, max_new_tokens)``
    for ``traffic["rounds"]`` rounds."""
    n = traffic["clients"]
    rng = np.random.default_rng([seed & MASK, 0x7AFF1C])
    prompts = quantiles(traffic["prompt"], n)
    outputs = quantiles(traffic["output"], n)
    first = outputs
    if traffic.get("first_wave") == "residual":
        first = residuals(outputs)
    out = [[] for _ in range(n)]
    for r in range(traffic["rounds"]):
        p = rng.permutation(n)
        o = rng.permutation(n)
        lens = first if r == 0 else outputs
        for c in range(n):
            ids = rng.integers(0, vocab, prompts[p[c]])
            out[c].append((ids.tolist(), lens[o[c]]))
    return out


def residuals(outputs: list) -> list:
    """What is left of each output in a loop that has run a while: the
    ``i``-th length times the fraction ``(k_i + 0.5) / n``, where
    ``k_i = 37 i mod n`` scrambles the pairing (37 is prime, so ``k`` is
    a permutation for any ``n`` it does not divide); the same set for
    every seed."""
    n = len(outputs)
    step = 37 if n % 37 else 1
    return [max(1, int(round(x * (((i * step) % n) + 0.5) / n)))
            for i, x in enumerate(outputs)]


def warmup(traffic: dict, serving: dict, seed: int, vocab: int) -> list:
    """The set-up's requests: one prompt of a whole prefill chunk and a
    remainder of one padding multiple, one of the longest prompt, and a
    decode burst each, so every kernel and step the window launches has
    run once."""
    rng = np.random.default_rng([seed & MASK, 0x3A93])
    lens = [serving["prefill_chunk"] + serving["prefill_multiple"],
            traffic["prompt"]["max"]]
    new = serving["max_burst"] + 1
    return [(rng.integers(0, vocab, n).tolist(), new) for n in lens]
