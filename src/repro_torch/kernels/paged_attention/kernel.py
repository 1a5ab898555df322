"""Launcher for the CUDA paged decode attention
(``csrc/paged_attention.cu``).

The GPU counterpart of the TPU kernel
``repro/kernels/paged_attention/kernel.py::paged_attention``: one query
token per sequence attends over its paged KV cache, read in place
through its block table. Each row's KV walk is split into partitions of
whole blocks (flash-decoding): one thread block per (partition, kv head,
row) streams its K and V rows through a ``cp.async`` ring and writes its
softmax's (m, l, acc) in f32 to a workspace allocated here; a second
launch merges a row's partitions in partition order. A row that fits one
partition is written by the first launch, and a table that spans one
partition takes no second launch.

The partition (``partition_blocks``) depends on the block size alone, so
a row's sum order is the same alone or in any batch. The kernel is
bound by bytes (each live K/V element is read once); what it leaves on
the table is in the source's note. The library is built with ``nvcc`` at
first launch and bound with ``ctypes``; nothing is built or loaded when
this module is imported.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, counters

SOURCE = "paged_attention.cu"
SMEM_LIMIT = 227 * 1024           # bytes of shared memory a block may use
PART_POSITIONS = 128              # KV positions a partition aims at; at
#                                   most 128, the kernel reads one table
#                                   entry a thread
MAX_GROUP = 16                    # query heads per kv head
MAX_HEAD_DIM = 256
STAGES, ITEM_BYTES = 4, 64        # the K/V ring: 4 stages of 64 * D bytes
_FN = {torch.float32: "paged_attention_f32",
       torch.bfloat16: "paged_attention_bf16"}
_BOUND: dict = {}     # dtype -> C function with its signature set


def _function(dtype: torch.dtype):
    fn = _BOUND.get(dtype)
    if fn is None:
        fn = getattr(build.load(SOURCE), _FN[dtype])
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _BOUND[dtype] = fn
    return fn


def partition_blocks(block_size: int) -> int:
    """KV blocks in one partition of a row's walk: ``PART_POSITIONS``
    positions rounded down to whole blocks, at least one. It depends on
    the block size alone, never on the batch, the lengths or the card."""
    return max(1, PART_POSITIONS // block_size)


def n_partitions(max_blocks: int, block_size: int) -> int:
    """Partitions a table of ``max_blocks`` entries spans: the grid's
    first axis, from host integers only (never from ``lengths``)."""
    return -(-max_blocks // partition_blocks(block_size))


def smem_bytes(group: int, D: int, block_size: int) -> int:
    """Dynamic shared memory one partition block asks for: the K/V ring
    (stages of 64 bytes of each of D / 4 chunks: 16 positions in f32, 32
    in bf16), the group's pre-scaled query rows, the partition's scores
    (group rows of P + 1 floats), m and l, and the arena row of each of
    its P positions."""
    P = partition_blocks(block_size) * block_size
    return (STAGES * ITEM_BYTES * D
            + 4 * (group * (D + P + 1) + 2 * group) + 4 * P)


def merge_smem_bytes(n_parts: int) -> int:
    """Dynamic shared memory of the merge launch: the weight and the l of
    each partition, and the denominator."""
    return 4 * (2 * n_parts + 1)


def _check(q, k_arena, v_arena, block_tables, lengths) -> None:
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"paged_attention launches on CUDA tensors, got q "
                         f"on {dev}")
    for name, t in (("k_arena", k_arena), ("v_arena", v_arena),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    dtype = q.dtype
    if dtype not in _FN or k_arena.dtype != dtype \
            or v_arena.dtype != dtype:
        raise ValueError(f"q and the arenas must all be float32 or "
                         f"bfloat16, got {dtype}, {k_arena.dtype}, "
                         f"{v_arena.dtype}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("block_tables and lengths must be int32")
    qs, ks, ts = q.shape, k_arena.shape, block_tables.shape
    if len(qs) != 3 or len(ks) != 4 or ks != v_arena.shape:
        raise ValueError(f"q {tuple(qs)} must be (B, n_q, D) and the "
                         f"arenas {tuple(ks)} / {tuple(v_arena.shape)} one "
                         f"(n_blocks + 1, bs, n_kv, D) shape")
    B, n_q, D = qs
    _, bs, n_kv, Dk = ks
    if Dk != D or n_kv < 1 or n_q % n_kv:
        raise ValueError(f"q {tuple(qs)} does not group over the arena's "
                         f"{n_kv} kv heads of width {Dk}")
    if len(ts) != 2 or ts[0] != B or ts[1] < 1 or lengths.shape != (B,):
        raise ValueError(f"block_tables {tuple(ts)} / lengths "
                         f"{tuple(lengths.shape)} do not match B = {B}")
    if B > 65535 or n_kv > 65535:
        raise ValueError(f"B = {B} or n_kv = {n_kv} exceeds the grid")
    group = n_q // n_kv
    if group > MAX_GROUP or D % 4 or D > MAX_HEAD_DIM:
        raise ValueError(f"group {group} and head width {D}: the kernel "
                         f"takes groups up to {MAX_GROUP} and widths that "
                         f"are multiples of 4 up to {MAX_HEAD_DIM}")
    if smem_bytes(group, D, bs) > SMEM_LIMIT \
            or merge_smem_bytes(n_partitions(ts[1], bs)) > SMEM_LIMIT:
        raise ValueError(f"group {group}, D {D}, block {bs}, {ts[1]} table "
                         f"entries need more shared memory than a block "
                         f"has")
    if k_arena.data_ptr() % 16 or v_arena.data_ptr() % 16:
        raise ValueError("the arenas must start on 16 bytes (cp.async)")
    for name, t in (("q", q), ("k_arena", k_arena), ("v_arena", v_arena),
                    ("block_tables", block_tables), ("lengths", lengths)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def paged_attention(q: torch.Tensor, k_arena: torch.Tensor,
                    v_arena: torch.Tensor, block_tables: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. q: (B, n_q, D); arenas:
    (n_blocks + 1, bs, n_kv, D); block_tables: (B, max_blocks) int32
    arena block ids; lengths: (B,) int32 valid KV positions per row.
    Returns (B, n_q, D) in q's dtype. Raises on anything the kernel does
    not take. Never synchronises: the grid comes from the table's width,
    not from ``lengths``."""
    _check(q, k_arena, v_arena, block_tables, lengths)
    B, n_q, D = q.shape
    _, bs, n_kv, _ = k_arena.shape
    out = torch.empty_like(q)
    if B == 0:
        return out
    max_blocks = block_tables.shape[1]
    n_parts = n_partitions(max_blocks, bs)
    ws = (torch.empty(B * n_kv * n_parts * (n_q // n_kv) * (D + 2),
                      dtype=torch.float32, device=q.device)
          if n_parts > 1 else None)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _function(q.dtype)(
        q.data_ptr(), k_arena.data_ptr(), v_arena.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(), B, n_q, n_kv, D, bs,
        max_blocks, partition_blocks(bs), 1.0 / math.sqrt(D), stream)
    if err != 0:
        raise RuntimeError(f"paged_attention kernel launch failed: CUDA "
                           f"error {err}")
    counters.record("paged_attention")
    return out
