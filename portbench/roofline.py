"""The yardstick's arithmetic: the card's published peaks, the least time
a piece of work can take on it, the classes of device kernels by name,
and the bytes and operations of the served model's calls.

Counts come from the benchmark's own inputs and the traced slice's
traffic, never from the port's padded shapes: the live blocks of the
generator's masks, the active sequences and their cache lengths, the
real tokens of each prefill chunk, and, for the experts, the routed
assignments. Each weight byte is counted once per call, each cache byte
read once, each output written once. So a later kernel that does the
same work another way reads the same count.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at its 700 W limit):
989 TFLOP/s bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
BF16 = 2


def bound_s(n_bytes: float, n_ops: float, dtype: str = "bfloat16") -> float:
    """The least time of the work: the larger of its bytes over the
    bandwidth and its operations over the peak rate."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / PEAK_OPS[dtype])


GEMM_MARKS = ("gemm", "gemv", "cutlass", "xmma", "cublas", "splitk")
MARKER = "spin_kernel"          # the harness's phase marker (trace runs)


def kernel_class(name: str) -> str:
    """A device kernel's class by its name: the port's kernels by their
    entry points (k1 block_sparse_kernel, k3 paged_attention_*, k6
    grouped_kernel / grouped_shared_x_kernel, k7 ragged_kernel), the
    libraries' matmuls, or the rest."""
    n = name.lower()
    if MARKER in n:
        return "marker"
    if "quant_" in n:
        return "other"
    for key, cls in (("grouped_kernel", "k6"), ("grouped_shared_x", "k6"),
                     ("ragged_kernel", "k7"), ("block_sparse_kernel", "k1"),
                     ("paged_attention", "k3"), ("flash_", "k4")):
        if key in n:
            return cls
    if any(m in n for m in GEMM_MARKS):
        return "gemm"
    if "softmax" in n:
        return "softmax"
    if "reduce" in n:
        return "reduce"
    return "other"


def busy_s(spans: list) -> float:
    """Length of the union of ``(start, end)`` intervals (seconds)."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy


# ------------------------------------------------------------ calls

def _fold(desc: dict, i: int, name: str) -> tuple:
    K, N = desc["layers"][i]["fold"][name]
    return K, N


def live_weight_bytes(desc: dict, i: int, name: str) -> int:
    L = desc["layers"][i]
    K, N = L["fold"][name]
    b = desc["block"]
    return L["live_per_col"][name] * (N // b) * b * b * BF16


def projection_call(desc: dict, i: int, name: str, rows: int,
                    experts: float = 1.0) -> tuple:
    """``(bytes, ops)`` of one block-sparse call of layer ``i``'s
    projection ``name`` over ``rows`` rows: the live weight tiles of
    ``experts`` experts (1 for a dense MLP), the rows in and out."""
    K, N = _fold(desc, i, name)
    w = live_weight_bytes(desc, i, name)
    density = w / (K * N * BF16)
    return (experts * w + rows * (K + N) * BF16,
            2.0 * rows * K * N * density)


def paged_attention_call(desc: dict, i: int, kv_lens: list) -> tuple:
    """``(bytes, ops)`` of one decode attention call of layer ``i`` over
    sequences whose caches hold ``kv_lens`` tokens (the new one
    included): K and V read once, q read and the output written."""
    hd, n_kv, n_q = desc["head_dim"], desc["n_kv"], desc["layers"][i]["n_q"]
    t = sum(kv_lens)
    return (2 * t * n_kv * hd * BF16 + 2 * len(kv_lens) * n_q * hd * BF16,
            4.0 * t * n_q * hd)


def decode_ticks(burst: dict) -> list:
    """Each tick of a decode burst as the cache lengths it attends over."""
    return [[n + 1 + k for n in burst["lens"]] for k in range(burst["ticks"])]


def step_call(desc: dict, rows: int, kv_read: int, kv_new: int,
              attn_pairs: int, expert_frac: float = 1.0) -> tuple:
    """``(bytes, ops)`` of one whole forward of ``rows`` tokens: every
    weight read once (the live tiles of the attention and feed-forward
    projections; for an MoE the live tiles of ``expert_frac`` of the
    experts and the router), the head, ``kv_read`` cache positions read and ``kv_new``
    written per layer, the logits written; operations for the
    projections over the rows (experts: top-k assignments) and for
    ``attn_pairs`` query-key pairs per layer."""
    d, hd, n_kv = desc["d_model"], desc["head_dim"], desc["n_kv"]
    V = desc["vocab"]
    nbytes = d * V * BF16 + rows * d * BF16 + rows * V * BF16
    ops = 2.0 * rows * d * V
    moe = desc["moe"]
    for i, L in enumerate(desc["layers"]):
        attn_w = sum(live_weight_bytes(desc, i, n) for n in
                     ("q", "k", "v", "o")) / BF16
        nbytes += attn_w * BF16 + (kv_read + kv_new) * 2 * n_kv * hd * BF16
        ops += 2.0 * rows * attn_w + 4.0 * attn_pairs * L["n_q"] * hd
        for name in ("gate", "up", "down"):
            w = live_weight_bytes(desc, i, name)
            if moe is None:
                nbytes += w
                ops += 2.0 * rows * w / BF16
            else:
                nbytes += expert_frac * moe["n_experts"] * w
                ops += 2.0 * rows * moe["top_k"] * w / BF16
        if moe is not None:
            nbytes += d * moe["n_experts"] * BF16
            ops += 2.0 * rows * d * moe["n_experts"]
    return nbytes, ops
