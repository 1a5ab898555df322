"""The port's CUDA kernels against their plain versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA card.

The file imports neither JAX nor the JAX package, so it also runs on a
machine with PyTorch alone (``--noconftest`` skips the JAX fixtures of
``tests/conftest.py``):

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import counters
from repro_torch.kernels.block_sparse import kernel as bs_kernel
from repro_torch.kernels.block_sparse import ops as bs_ops
from repro_torch.kernels.block_sparse import ref as bs_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.grouped_block_sparse import kernel as gbs_kernel
from repro_torch.kernels.grouped_block_sparse import ops as gbs_ops
from repro_torch.kernels.grouped_block_sparse import ref as gbs_ref
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.ssd_scan import kernel as ssd_kernel
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan import ref as ssd_ref
from repro_torch.kernels.wanda_metric import kernel as wm_kernel
from repro_torch.kernels.wanda_metric import ops as wm_ops
from repro_torch.kernels.wanda_metric import ref as wm_ref
from repro_torch.models import moe
from repro_torch.models import transformer as T
from repro_torch.models.specs import (LayerSpec, MambaSpec, ModelConfig,
                                      MoESpec)
from repro_torch.serve import sparse as serve_sparse
from repro_torch.serve.sparse import pack_projection, sparse_linear

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, plain, dtype):
    """f32: summation order; bf16: the kernel rounds its f32 sum once.
    Held in max-abs against the largest plain value, and in the Frobenius
    norm of the error against the plain output's, so the bulk of small
    values is held to its own scale too."""
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    diff = got.float() - plain.float()
    assert diff.abs().max().item() <= tol * max(
        1.0, plain.float().abs().max().item())
    assert diff.norm().item() <= tol * plain.float().norm().item()


def _plan_case(block: int, seed: int, M=None):
    """x (M, K), block-masked w (K, N) with empty columns, block map."""
    rng = np.random.default_rng(seed)
    M, K, N = M or block, 3 * block, 5 * block
    bm = rng.random((K // block, N // block)) < 0.6
    bm[:, 0] = False
    bm[:, 1] = True
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    w *= np.repeat(np.repeat(bm, block, 0), block, 1)
    return x, w, bm


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 37, 64, 130])
def test_block_sparse_kernel_matches_plain(cuda, block, dtype, M):
    x, w, bm = _plan_case(block, 10, M)
    counts, indices = bs_ops.plan_blocks(bm)
    xt = torch.from_numpy(x).to(cuda, dtype)
    wt = torch.from_numpy(w).to(cuda, dtype)
    ct = torch.from_numpy(counts).to(cuda)
    it = torch.from_numpy(indices).to(cuda)
    counters.reset()
    y = bs_ops.blocksparse_matmul(xt, wt, ct, it, block)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"block_sparse": 1}
    plain = bs_ref.block_sparse_matmul_ref(xt.float(), wt.float(),
                                           torch.from_numpy(bm).to(cuda),
                                           block, block)
    _close(y, plain, dtype)
    assert y.dtype == dtype and not y[:, :block].any()


def test_block_sparse_kernel_raises_on_what_it_does_not_take(cuda):
    x, w, bm = _plan_case(16, 11)
    counts, indices = (torch.from_numpy(a).to(cuda)
                       for a in bs_ops.plan_blocks(bm))
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    bad = [
        (xt.half(), wt.half(), counts, indices, 16),        # dtype
        (xt, wt.bfloat16(), counts, indices, 16),           # mixed dtypes
        (xt, wt, counts.long(), indices, 16),               # plan dtype
        (xt, wt, counts, indices, 48),                      # block
        (xt[:, :32], wt, counts, indices, 16),              # shapes
        (xt, wt.T.contiguous().T, counts, indices, 16),     # layout
        (xt, wt, counts[:-1], indices, 16),                 # plan shape
        (xt, wt.cpu(), counts, indices, 16),                # device
        (torch.zeros(xt.numel() + 1, device=cuda)[1:].view(xt.shape),
         wt, counts, indices, 16),                          # 16-byte start
    ]
    for args in bad:
        with pytest.raises(ValueError):
            bs_kernel.block_sparse_matmul(*args)


@pytest.mark.parametrize("M", [1, 16, 63, 64, 128, 3072])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight", ["dense", "int8"])
def test_block_sparse_tile_config_mirrors_the_library(cuda, M, dtype,
                                                      weight):
    for block in bs_kernel.BLOCKS:
        want = bs_kernel.tile_config(M, block, dtype, weight)
        got = bs_kernel.library_tile_config(M, block, dtype, weight)
        assert got == {k: want[k] for k in got}, (block, got, want)


def _kernel1_and_one_expert(cuda, block, M, dtype, panel):
    """Kernel 1 and kernel 6 with one expert over the same plan and x
    (M, K), kernel 6 in panels of 16 rows or of all Mp rows (``panel``)."""
    rng = np.random.default_rng(14)
    K, N = 6 * block, 5 * block
    bm = rng.random((K // block, N // block)) < 0.6
    bm[:, 0] = False
    bm[:, 1] = True
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    w *= np.repeat(np.repeat(bm, block, 0), block, 1)
    x = rng.standard_normal((M, K)).astype(np.float32)
    counts, indices = (torch.from_numpy(a).to(cuda)
                       for a in bs_ops.plan_blocks(bm))
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    y1 = bs_kernel.block_sparse_matmul(xt, wt, counts, indices, block)
    Mp = -(-M // 16) * 16                  # kernel 6 takes M % block_m == 0
    block_m = Mp if panel else 16
    xp = torch.nn.functional.pad(xt, (0, 0, 0, Mp - M))
    work = torch.ones((1, Mp // block_m), dtype=torch.int32, device=cuda)
    y6 = gbs_kernel.grouped_block_sparse_matmul(
        xp[None].contiguous(), wt[None].contiguous(), counts[None].contiguous(),
        indices[None].contiguous(), work, block, block_m)
    torch.cuda.synchronize()
    return y1, y6[0, :M]


@pytest.mark.parametrize("M,block_m", [(16, 16), (48, 48), (64, 64),
                                       (160, 80), (240, 240), (3072, 16),
                                       (3072, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("weight", ["dense", "int8"])
def test_grouped_tile_config_mirrors_the_library(cuda, M, block_m, dtype,
                                                 weight):
    for block in gbs_kernel.BLOCKS:
        want = gbs_kernel.tile_config(M, block_m, block, dtype, weight)
        got = gbs_kernel.library_tile_config(M, block_m, block, dtype,
                                             weight)
        assert got == {k: want[k] for k in got}, (block, got, want)


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("M", [16, 130])
def test_block_sparse_kernel_f32_bitwise_to_grouped_one_expert(cuda, block,
                                                               M):
    """f32 kernels 1 and 6 (and 7) run one warp routine
    (block_sparse_pipe.cuh) with one fmaf order (live K-blocks in plan
    order, k ascending): one expert of kernel 6 over the same plan gives
    kernel 1's bits, also where kernel 1 takes 64-row M-tiles (M 130) and
    kernel 6 16-row ones (16-row panels)."""
    y1, y6 = _kernel1_and_one_expert(cuda, block, M, torch.float32, False)
    assert torch.equal(y1, y6)


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("M", [16, 130, 240])
@pytest.mark.parametrize("panel", [False, True])
def test_block_sparse_kernel_bf16_bitwise_to_grouped_one_expert(cuda, block,
                                                                M, panel):
    """bf16 kernels 1 and 6 run the same mma.sync items in the same order
    (one f32 sum over the k16 items in plan order, rounded once): one
    expert of kernel 6 gives kernel 1's bits at 16- and 64-row M-tiles,
    in 16-row panels and in one panel of all rows."""
    y1, y6 = _kernel1_and_one_expert(cuda, block, M, torch.bfloat16, panel)
    assert y1.dtype == torch.bfloat16 and torch.equal(y1, y6)


def test_sparse_linear_pads_rows_to_the_block(cuda):
    x, w, _ = _plan_case(16, 12, M=5)
    wt = torch.from_numpy(w).to(cuda)
    plan = pack_projection(wt, block=16)
    xt = torch.from_numpy(x).to(cuda).reshape(5, 1, -1)
    y = sparse_linear(xt, wt, plan)
    assert y.shape == (5, 1, w.shape[1])
    err = (y - xt @ wt).abs().max().item()
    assert err <= 1e-4 * max(1.0, (xt @ wt).abs().max().item())


@pytest.mark.parametrize("shape", [(1000, 3000), (4096, 1024), (64, 256)])
def test_outlier_ratio_kernel_matches_plain(cuda, shape):
    K, N = shape
    rng = np.random.default_rng(13)
    wt = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                          ).to(cuda)
    at = torch.from_numpy((rng.random(K) + 0.5).astype(np.float32)).to(cuda)
    counters.reset()
    r = float(wm_ops.outlier_ratio(wt, at, 5.0))
    assert counters.snapshot() == {"wanda_partials": 2}
    r_plain = float(wm_ref.outlier_ratio_ref(wt, at, 5.0))
    assert abs(r - r_plain) <= 2 * 100.0 / (K * N)   # one threshold flip
    part = wm_kernel.wanda_partials(wt, at)
    plain = wm_ref.wanda_partials_ref(wt, at, block_k=wm_kernel.BLOCK_K,
                                      block_n=wm_kernel.BLOCK_N)
    assert part.shape == plain.shape
    assert (part - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()
    assert (part - plain).norm().item() <= 1e-5 * plain.norm().item()


@pytest.mark.parametrize("shape", [(100, 300), (1000, 3000), (4096, 1024),
                                   (64, 256), (65, 257)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("count", [False, True])
def test_wanda_partials_kernel_matches_plain(cuda, shape, dtype, count):
    """Per-tile sums within 1e-5 of the largest partial, as a whole (the
    Frobenius norm of the error) too; per-tile counts exact (the kernel
    forms |w| * anorm with the plain version's one rounding); ragged
    edges; two launches bitwise equal (a fixed reduction order)."""
    K, N = shape
    rng = np.random.default_rng(14 + K)
    wt = torch.from_numpy(rng.standard_normal((K, N)).astype(np.float32)
                          ).to(cuda, dtype)
    at = torch.from_numpy((rng.random(K) + 0.5).astype(np.float32)).to(cuda)
    thr = None
    if count:
        thr = (3.0 * wm_ref.metric_ref(wt, at).mean()).reshape(1)
    counters.reset()
    part = wm_kernel.wanda_partials(wt, at, thr)
    again = wm_kernel.wanda_partials(wt, at, thr)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"wanda_partials": 2}
    assert torch.equal(part, again)
    plain = wm_ref.wanda_partials_ref(wt, at, thr, block_k=wm_kernel.BLOCK_K,
                                      block_n=wm_kernel.BLOCK_N)
    assert part.shape == plain.shape == (-(-K // 64), -(-N // 256))
    if count:
        assert torch.equal(part, plain)
    else:
        diff = part - plain
        assert diff.abs().max().item() <= 1e-5 * plain.abs().max().item()
        assert diff.norm().item() <= 1e-5 * plain.norm().item()


def test_wanda_partials_kernel_takes_strided_rows(cuda):
    """A row stride off 16 bytes takes the element-by-element loads."""
    rng = np.random.default_rng(15)
    full = torch.from_numpy(rng.standard_normal((130, 301)).astype(
        np.float32)).to(cuda)
    wt = full[:, 1:300]
    at = torch.from_numpy((rng.random(130) + 0.5).astype(np.float32)
                          ).to(cuda)
    part = wm_kernel.wanda_partials(wt, at)
    plain = wm_ref.wanda_partials_ref(wt, at, block_k=wm_kernel.BLOCK_K,
                                      block_n=wm_kernel.BLOCK_N)
    assert (part - plain).abs().max().item() <= 1e-5 * plain.abs().max().item()


def test_wanda_partials_kernel_raises_on_what_it_does_not_take(cuda):
    wt = torch.ones((64, 256), device=cuda)
    at = torch.ones((64,), device=cuda)
    bad = [(wt.cpu(), at.cpu(), None), (wt.half(), at, None),
           (wt, at.double(), None), (wt, at[:32], None),
           (wt.t(), torch.ones((256,), device=cuda), None),
           (wt, at, torch.ones((2,), device=cuda)),
           (wt, at, torch.ones((1,), device=cuda, dtype=torch.float64)),
           (wt[:0], at[:0], None)]
    for w_, a_, t_ in bad:
        with pytest.raises(ValueError):
            wm_kernel.wanda_partials(w_, a_, t_)


# f32: summation order (online softmax vs one softmax); bf16: both round
# their output to bf16, and their probabilities before P.V (the plain
# version the normalised ones, flash attention's tensor-core routine the
# unnormalised ones; paged attention keeps them in f32), so they part by
# about one bf16 ulp of the largest output. The largest outputs sit in
# the first rows, so the bulk is also held to its own scale: the
# Frobenius norm of the error within the same fraction of the plain one's
ATTN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _attn_close(got, plain, dtype):
    diff = got.float() - plain.float()
    err = diff.abs().max().item()
    assert err <= ATTN_RTOL[dtype] * max(1.0, plain.float().abs().max().item())
    rel = diff.norm().item() / max(plain.float().norm().item(), 1e-30)
    assert rel <= ATTN_RTOL[dtype]


def _paged_case(group: int, block: int, seed: int, n_kv=2, D=128, B=6,
                max_blocks=5):
    """q (B, n_q, D), arenas with a scratch block, tables, lengths, with
    row 1 at length 0, row 2 masked to the scratch block at length 1, and
    row 4 reading row 0's blocks with row 0's query and length."""
    rng = np.random.default_rng(seed)
    n_blocks = B * max_blocks
    n_q = n_kv * group
    q = rng.standard_normal((B, n_q, D)).astype(np.float32)
    k = rng.standard_normal((n_blocks + 1, block, n_kv, D)).astype(np.float32)
    v = rng.standard_normal((n_blocks + 1, block, n_kv, D)).astype(np.float32)
    tables = rng.permutation(n_blocks)[:B * max_blocks].reshape(
        B, max_blocks).astype(np.int32)
    lengths = rng.integers(1, max_blocks * block + 1, (B,)).astype(np.int32)
    lengths[1] = 0
    tables[2] = n_blocks
    lengths[2] = 1
    tables[4], lengths[4], q[4] = tables[0], lengths[0], q[0]
    lengths[5] = max_blocks * block
    return q, k, v, tables, lengths


@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("block", [8, 16, 32])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_matches_plain(cuda, group, block, dtype):
    q, k, v, tables, lengths = (torch.from_numpy(a).to(cuda) for a in
                                _paged_case(group, block, 20 + group))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    counters.reset()
    out = pa_ops.paged_attention_decode(q[:, None], k, v, tables, lengths)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"paged_attention": 1}
    out = out[:, 0]
    assert out.shape == q.shape and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    assert not out[1].any(), "a length-0 row gives zeros"
    assert torch.equal(out[4], out[0]), "shared tables give equal rows"
    plain = pa_ref.paged_attention_ref(q, k, v, tables, lengths)
    live = lengths > 0
    _attn_close(out[live], plain[live], dtype)


def test_paged_attention_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v, tables, lengths = (torch.from_numpy(a).to(cuda) for a in
                                _paged_case(3, 16, 30))
    bad = [
        (q.cpu(), k.cpu(), v.cpu(), tables.cpu(), lengths.cpu()),  # device
        (q.half(), k.half(), v.half(), tables, lengths),    # dtype
        (q, k.bfloat16(), v, tables, lengths),              # mixed dtypes
        (q, k, v, tables.long(), lengths),                  # table dtype
        (q[:, :5], k, v, tables, lengths),                  # group
        (q[:, :, :64], k, v, tables, lengths),              # head width
        (q, k, v[:-1], tables, lengths),                    # arena shapes
        (q, k, v, tables[:-1], lengths),                    # table rows
        (q.transpose(0, 1).contiguous().transpose(0, 1), k, v, tables,
         lengths),                                          # layout
        (q, k, v, tables.cpu(), lengths),                   # mixed devices
        (torch.cat([q] * 6, 1)[:, :34].contiguous(), k, v, tables,
         lengths),                                          # group 17
        (q[..., :126].contiguous(), k[..., :126].contiguous(),
         v[..., :126].contiguous(), tables, lengths),       # D % 4
        (q, torch.empty(k.numel() + 1, device=cuda)[1:].view(k.shape), v,
         tables, lengths),                                  # alignment
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pa_kernel.paged_attention(*args)


def _edge_lengths(block: int, n_parts: int) -> tuple:
    """Lengths on the partition edges of a table ``n_parts`` partitions
    wide (the last one short by a block): 1, P - 1, P, P + 1, 2P + 1 and
    the full table; and that table width."""
    P = pa_kernel.partition_blocks(block) * block
    max_blocks = n_parts * pa_kernel.partition_blocks(block) - 1
    full = max_blocks * block
    return [min(n, full) for n in (1, P - 1, P, P + 1, 2 * P + 1, full)], \
        max_blocks


def _paged_rows(lengths, group, block, max_blocks, seed, n_kv=2, D=128):
    """q, a shuffled arena with a scratch block, tables, lengths."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    n_blocks = B * max_blocks
    q = rng.standard_normal((B, n_kv * group, D)).astype(np.float32)
    k, v = (rng.standard_normal((n_blocks + 1, block, n_kv, D)).astype(
        np.float32) for _ in range(2))
    tables = rng.permutation(n_blocks).reshape(B, max_blocks).astype(
        np.int32)
    return q, k, v, tables, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("group", [1, 3, 8])
@pytest.mark.parametrize("block", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_partition_edges(cuda, group, block, dtype):
    """Lengths at the partition edges of a table four partitions wide,
    a length-0 row and the full row's twin: within tolerance of the plain
    version, zeros, and the twin bitwise equal."""
    lengths, max_blocks = _edge_lengths(block, 4)
    lengths += [0, lengths[-1]]
    q, k, v, tables, lens = (torch.from_numpy(a).to(cuda) for a in
                             _paged_rows(lengths, group, block, max_blocks,
                                         50 + block))
    tables[-1] = tables[-3]
    q[-1] = q[-3]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    counters.reset()
    out = pa_kernel.paged_attention(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"paged_attention": 1}
    assert torch.isfinite(out.float()).all()
    assert not out[-2].any(), "a length-0 row gives zeros"
    assert torch.equal(out[-1], out[-3]), "the twin row is bitwise equal"
    plain = pa_ref.paged_attention_ref(q, k, v, tables, lens)
    live = lens > 0
    _attn_close(out[live], plain[live], dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_batch_invariant(cuda, dtype):
    """A row gives the same bits alone as inside a batch of 8: its sum
    order depends on its own inputs alone."""
    lengths = [3115, 17, 300, 129, 0, 1, 2048, 640]
    q, k, v, tables, lens = (torch.from_numpy(a).to(cuda) for a in
                             _paged_rows(lengths, 3, 16, 224, 60,
                                         n_kv=8))
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    batch = pa_kernel.paged_attention(q, k, v, tables, lens)
    for b in (0, 3, 6):
        alone = pa_kernel.paged_attention(q[b:b + 1].contiguous(), k, v,
                                          tables[b:b + 1].contiguous(),
                                          lens[b:b + 1].contiguous())
        assert torch.equal(alone[0], batch[b]), f"row {b}"
    torch.cuda.synchronize()
    assert not batch[4].any(), "a length-0 row gives zeros"
    plain = pa_ref.paged_attention_ref(q, k, v, tables, lens)
    live = lens > 0
    _attn_close(batch[live], plain[live], dtype)


@pytest.mark.parametrize("group,n_kv,D", [(8, 1, 256), (12, 8, 192),
                                          (3, 2, 64), (3, 2, 68),
                                          (3, 2, 132)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_attention_kernel_wide_heads(cuda, group, n_kv, D, dtype):
    """gemma-2b's heads (8 q / 1 kv, D 256) and nemotron-4-340b's (96 q
    / 8 kv, D 192), and widths no served model reaches: lanes past D at
    D 64 and 68, bf16 rows of 8k + 8 bytes (D 68 and 132, the 8-byte
    copies); over a table several partitions wide, with a length-0 row
    and the full row's twin."""
    lengths, max_blocks = _edge_lengths(16, 3)
    lengths += [0, lengths[-1]]
    q, k, v, tables, lens = (torch.from_numpy(a).to(cuda) for a in
                             _paged_rows(lengths, group, 16, max_blocks,
                                         70 + D, n_kv=n_kv, D=D))
    tables[-1] = tables[-3]
    q[-1] = q[-3]
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out = pa_kernel.paged_attention(q, k, v, tables, lens)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert not out[-2].any(), "a length-0 row gives zeros"
    assert torch.equal(out[-1], out[-3]), "the twin row is bitwise equal"
    plain = pa_ref.paged_attention_ref(q, k, v, tables, lens)
    live = lens > 0
    _attn_close(out[live], plain[live], dtype)


def _flash_inputs(B, S, group, n_kv, D, dtype, seed, device):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(
        (B, S, h, D)).astype(np.float32)).to(device, dtype)
        for h in (n_kv * group, n_kv, n_kv))


@pytest.mark.parametrize("S", [64, 192, 1024, 3072])
@pytest.mark.parametrize("group", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, S, group, dtype):
    """B 2, 2 kv heads, D 128: S of one 64-row tile, of a 128-row tile
    and a half (S 192), and the long prefills; groups 1 to 12."""
    q, k, v = _flash_inputs(2, S, group, 2, 128, dtype, 40 + group, cuda)
    counters.reset()
    out = fa_ops.flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"flash_attention": 1}
    assert out.shape == q.shape and out.dtype == dtype
    _attn_close(out, fa_ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("D", [16, 32, 64, 128, 192, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_head_widths(cuda, D, dtype):
    q, k, v = _flash_inputs(2, 128, 3, 2, D, dtype, 50 + D, cuda)
    _attn_close(fa_kernel.flash_attention(q, k, v),
                fa_ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_is_deterministic(cuda, dtype):
    q, k, v = _flash_inputs(2, 1024, 3, 2, 128, dtype, 60, cuda)
    first = fa_kernel.flash_attention(q, k, v)
    assert torch.equal(first, fa_kernel.flash_attention(q, k, v))


def test_flash_attention_kernel_raises_on_what_it_does_not_take(cuda):
    q, k, v = (torch.zeros((1, 128, h, 128), device=cuda)
               for h in (6, 2, 2))
    bad = [
        (q.cpu(), k.cpu(), v.cpu()),                        # device
        (q.half(), k.half(), v.half()),                     # dtype
        (q, k.bfloat16(), v),                               # mixed dtypes
        (q[:, :100], k[:, :100], v[:, :100]),               # S % 64
        (q[:, :, :5], k, v),                                # group
        (q[..., :48], k[..., :48], v[..., :48]),            # head width
        (q, k, v[:, :64]),                                  # kv shapes
        (q.transpose(1, 2).contiguous().transpose(1, 2), k, v),  # layout
        (q, k.cpu(), v),                                    # mixed devices
    ]
    # bf16 views that are contiguous but start 2 bytes past 16: the
    # routine's 16-byte cp.async copies cannot read them
    qb, kb = q.bfloat16(), k.bfloat16()

    def off16(t):
        flat = torch.zeros(t.numel() + 8, dtype=t.dtype, device=t.device)
        return flat[1:1 + t.numel()].view(t.shape)

    bad += [(off16(qb), kb, kb), (qb, off16(kb), kb), (qb, kb, off16(kb))]
    for args in bad:
        with pytest.raises(ValueError):
            fa_kernel.flash_attention(*args)
    assert fa_kernel.flash_attention(qb, kb, kb).shape == qb.shape


# ------------------------------------------- grouped and ragged (MoE)

def _expert_case(block: int, seed: int, E=5, M=48):
    """x (E, M, K), a block-masked expert stack w (E, K, N) whose experts
    differ in live tiles (so the stacked plan pads max_nnz), an empty
    column in every expert, an empty expert 0, and the stacked plan."""
    rng = np.random.default_rng(seed)
    K, N = 4 * block, 3 * block
    masks = rng.random((E, K // block, N // block)) < 0.5
    masks[1] = True                          # a dense expert: max max_nnz
    masks[:, :, 0] = False
    masks[:, :, 1] = True
    masks[0] = False
    x = rng.standard_normal((E, M, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) / np.sqrt(K)).astype(np.float32)
    w *= np.repeat(np.repeat(masks, block, 1), block, 2)
    plans = [bs_ops.plan_blocks(m) for m in masks]
    counts, indices = gbs_ops.stack_expert_plans(*zip(*plans))
    return x, w, masks, counts, indices




@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,block_m", [(48, None), (48, 16), (192, 64),
                                       (160, 80), (240, None)])
def test_grouped_kernel_matches_plain(cuda, block, dtype, M, block_m):
    """16-row tiles (panels below 64 rows), 64-row tiles (panels of 64
    rows and more), a panel's masked last tile (80 and 240 rows), and
    dead panels beside live ones, in both types."""
    x, w, masks, counts, indices = _expert_case(block, 60, M=M)
    E = x.shape[0]
    live = np.zeros((E, M), bool)
    live[1] = True
    live[2, :3] = True                       # one live row: first panel
    live[2, M // 2] = True                   # and one in a middle panel
    live[3, M - 8:] = True                   # the last panel only
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    ct, it = torch.from_numpy(counts).to(cuda), torch.from_numpy(
        indices).to(cuda)
    rl = torch.from_numpy(live).to(cuda)
    counters.reset()
    y = gbs_ops.grouped_blocksparse_matmul(xt, wt, ct, it, block,
                                           block_m=block_m, row_live=rl)
    torch.cuda.synchronize()
    bm = M if block_m is None else block_m
    work = live.reshape(E, M // bm, bm).any(-1)
    assert counters.snapshot() == {
        "grouped_block_sparse": 1,
        "grouped_block_sparse_experts_computed": int(work.any(-1).sum())}
    plain = gbs_ref.grouped_block_sparse_matmul_ref(
        xt.float(), wt.float(), torch.from_numpy(masks).to(cuda), block,
        block, work=torch.from_numpy(work.astype(np.int32)), block_m=bm)
    assert y.dtype == dtype and y.shape == (E, M, w.shape[2])
    _close(y, plain, dtype)
    dead = torch.from_numpy(~np.repeat(work, bm, 1)).to(cuda)
    assert not y[dead].any(), "dead panels are zeros"
    assert not y[:, :, :block].any(), "empty columns are zeros"
    assert not y[0].any() and not y[4].any()
    # every row live, no occupancy map: all experts computed
    counters.reset()
    y_all = gbs_ops.grouped_blocksparse_matmul(xt, wt, ct, it, block)
    assert counters.snapshot()["grouped_block_sparse_experts_computed"] == E
    _close(y_all, gbs_ref.grouped_block_sparse_matmul_ref(
        xt.float(), wt.float(), torch.from_numpy(masks).to(cuda), block,
        block), dtype)
    live_rows = torch.from_numpy(~dead.cpu().numpy()).to(cuda)
    assert torch.equal(y[live_rows], y_all[live_rows]), \
        "live rows do not depend on the occupancy map"


def _expert_runs(tile_expert) -> list:
    """(expert, first tile, end tile) of each run of consecutive tiles
    with one owner."""
    runs, t = [], 0
    while t < len(tile_expert):
        t1 = t + 1
        while t1 < len(tile_expert) and tile_expert[t1] == tile_expert[t]:
            t1 += 1
        runs.append((tile_expert[t], t, t1))
        t = t1
    return runs


@pytest.mark.parametrize("tile_expert,experts", [
    ([1, 1, 3, 0, 2, 4, -1, -1], 5),
    # expert 2 owns three consecutive tiles; E (5) marks a dead tile too
    ([2, 2, 2, 0, 1, 5, 5, -1], 3)])
@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ragged_kernel_matches_plain(cuda, block, dtype, tile_expert,
                                     experts):
    _, w, masks, counts, indices = _expert_case(block, 61)
    E = w.shape[0]
    M = 16 * len(tile_expert)
    x = np.random.default_rng(62).standard_normal(
        (M, w.shape[1])).astype(np.float32)
    xt, wt = (torch.from_numpy(a).to(cuda, dtype) for a in (x, w))
    te = torch.from_numpy(np.array(tile_expert, np.int32)).to(cuda)
    args = (torch.from_numpy(counts).to(cuda),
            torch.from_numpy(indices).to(cuda))
    counters.reset()
    y = gbs_ops.ragged_blocksparse_matmul(xt, wt, *args, te, block)
    torch.cuda.synchronize()
    assert counters.snapshot() == {
        "grouped_block_sparse_ragged": 1,
        "grouped_block_sparse_ragged_experts_computed": experts}
    plain = gbs_ref.ragged_block_sparse_matmul_ref(
        xt.float(), wt.float(), te, 16, torch.from_numpy(masks).to(cuda),
        block, block)
    _close(y, plain, dtype)
    for t, e in enumerate(tile_expert):
        # dead tiles (< 0 or >= E) and the empty expert 0 give zeros
        if not 1 <= e < E:
            assert not y[16 * t:16 * t + 16].any(), (t, e)
    # any owner past E is as dead as E, and reads nothing
    far = torch.where(te >= E, te + 3, te)
    assert torch.equal(gbs_kernel.ragged_block_sparse_matmul(
        xt, wt, *args, far, block), y)
    # a run of tiles equals kernel 1 on its expert alone, bitwise in both
    # types: one warp routine (f32 one fmaf order; bf16 the same mma.sync
    # items in the same order)
    for e, t0, t1 in _expert_runs(tile_expert):
        if not 0 <= e < E:
            continue
        solo = bs_kernel.block_sparse_matmul(
            xt[16 * t0:16 * t1].contiguous(), wt[e].contiguous(),
            args[0][e].contiguous(), args[1][e].contiguous(), block)
        assert torch.equal(y[16 * t0:16 * t1], solo), (e, t0, t1)


def test_ragged_kernel_takes_more_than_65535_tiles(cuda):
    """The grid is one-dimensional over warps, so the packed buffer may
    hold more 16-row tiles than a grid's second dimension allows."""
    block = 16
    _, w, masks, counts, indices = _expert_case(block, 63)
    n_tiles = 65536 + 4
    tile_expert = np.full(n_tiles, 1, np.int32)
    tile_expert[-4:] = (2, 3, -1, -1)
    M = 16 * n_tiles
    gen = torch.Generator(device=cuda).manual_seed(64)
    xt = torch.randn((M, w.shape[1]), generator=gen, device=cuda)
    wt = torch.from_numpy(w).to(cuda)
    te = torch.from_numpy(tile_expert).to(cuda)
    ct, it = (torch.from_numpy(a).to(cuda) for a in (counts, indices))
    y = gbs_kernel.ragged_block_sparse_matmul(xt, wt, ct, it, te, block)
    plain = gbs_ref.ragged_block_sparse_matmul_ref(
        xt, wt, te, 16, torch.from_numpy(masks).to(cuda), block, block)
    torch.cuda.synchronize()
    _close(y, plain, torch.float32)
    assert not y[-32:].any()


def _moe_layer(cuda, E=8, top_k=2, d=64, d_ff=64, block=16, seed=70):
    rng = np.random.default_rng(seed)
    spec = MoESpec(n_experts=E, top_k=top_k, d_ff=d_ff)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "up": rng.standard_normal((E, d, d_ff)) / np.sqrt(d),
         "gate": rng.standard_normal((E, d, d_ff)) / np.sqrt(d),
         "down": rng.standard_normal((E, d_ff, d)) / np.sqrt(d_ff)}
    for nm in ("up", "gate", "down"):
        w = p[nm]
        bm = rng.random((E, w.shape[1] // block, w.shape[2] // block)) < 0.6
        bm[:, 0, 0] = True
        w *= np.repeat(np.repeat(bm, block, 1), block, 2)
    params = {k: torch.from_numpy(v.astype(np.float32)).to(cuda)
              for k, v in p.items()}
    packed = {(0, nm): serve_sparse.pack_expert_projection(
        params[nm], block=block, ragged=True) for nm in ("gate", "up",
                                                         "down")}
    return spec, params, packed


def test_moe_paths_bitwise_equal_on_the_card(cuda):
    """ragged == grouped == per-expert loop bitwise on the card in f32
    (one fmaf order), each path through its own kernel."""
    spec, params, packed = _moe_layer(cuda)
    x = torch.from_numpy(np.random.default_rng(71).standard_normal(
        (4, 1, 64)).astype(np.float32)).to(cuda)
    bp = {"moe": params}
    out = {}
    for name, kw, kernel_name in (
            ("ragged", {"ragged_moe": True}, "grouped_block_sparse_ragged"),
            ("grouped", {"ragged_moe": False}, "grouped_block_sparse"),
            ("loop", {"ragged_moe": False, "group_experts": False},
             "block_sparse")):
        counters.reset()
        out[name] = serve_sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                                  **kw)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        want = 3 * (spec.n_experts if name == "loop" else 1)
        assert launches[kernel_name] == want, (name, launches)
    assert torch.equal(out["ragged"], out["grouped"])
    assert torch.equal(out["ragged"], out["loop"])
    dense, _ = moe.apply_moe(params, spec, x)
    _close(out["ragged"], dense, torch.float32)


def test_moe_loop_path_bitwise_to_ragged_in_bf16(cuda):
    """bf16: the per-expert loop (kernel 1) and the ragged path (kernel 7)
    run the same mma.sync items in the same order on one warp routine, so
    their rows are bitwise equal."""
    spec, params, packed = _moe_layer(cuda, seed=77)
    bp = {"moe": {k: v.bfloat16() for k, v in params.items()}}
    x = torch.from_numpy(np.random.default_rng(78).standard_normal(
        (4, 1, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    counters.reset()
    loop = serve_sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                         ragged_moe=False,
                                         group_experts=False)
    ragged = serve_sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                           ragged_moe=True)
    torch.cuda.synchronize()
    launches = counters.snapshot()
    assert launches["block_sparse"] == 3 * spec.n_experts
    assert launches["grouped_block_sparse_ragged"] == 3
    assert loop.dtype == ragged.dtype == torch.bfloat16
    assert torch.equal(loop, ragged)


@pytest.mark.parametrize("S", [1, 16])
def test_moe_paths_bitwise_equal_in_bf16(cuda, S):
    """bf16: the grouped path (kernel 6), the per-expert loop (kernel 1)
    and the ragged path (kernel 7) run the same mma.sync items in the
    same order, so an MoE layer's rows are bitwise equal across all
    three."""
    spec, params, packed = _moe_layer(cuda, seed=79)
    bp = {"moe": {k: v.bfloat16() for k, v in params.items()}}
    x = torch.from_numpy(np.random.default_rng(80).standard_normal(
        (4, S, 64)).astype(np.float32)).to(cuda, torch.bfloat16)
    out = {}
    for name, kw, kernel_name in (
            ("grouped", {"ragged_moe": False}, "grouped_block_sparse"),
            ("loop", {"ragged_moe": False, "group_experts": False},
             "block_sparse"),
            ("ragged", {"ragged_moe": True}, "grouped_block_sparse_ragged")):
        counters.reset()
        out[name] = serve_sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                                  **kw)
        torch.cuda.synchronize()
        want = 3 * (spec.n_experts if name == "loop" else 1)
        assert counters.snapshot()[kernel_name] == want, name
    assert out["grouped"].dtype == torch.bfloat16
    assert torch.equal(out["grouped"], out["loop"])
    assert torch.equal(out["grouped"], out["ragged"])


def test_ragged_switches_to_grouped_above_64_tokens(cuda):
    spec, params, packed = _moe_layer(cuda, seed=72)
    bp = {"moe": params}
    rng = np.random.default_rng(73)
    for S, kernel_name in ((64, "grouped_block_sparse_ragged"),
                           (65, "grouped_block_sparse")):
        x = torch.from_numpy(rng.standard_normal((1, S, 64)).astype(
            np.float32)).to(cuda)
        counters.reset()
        y = serve_sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                          ragged_moe=True)
        torch.cuda.synchronize()
        launches = counters.snapshot()
        assert launches[kernel_name] == 3, (S, launches)
        assert {k for k in launches if not k.endswith("computed")} \
            == {kernel_name}
        assert launches[kernel_name + "_experts_computed"] <= 3 * 8
        y_grp = serve_sparse.sparse_apply_moe(bp, spec, x, packed, 0,
                                              ragged_moe=False)
        assert torch.equal(y, y_grp)


def test_grouped_kernels_raise_on_what_they_do_not_take(cuda):
    x, w, _, counts, indices = _expert_case(16, 74, M=32)
    xt, wt = torch.from_numpy(x).to(cuda), torch.from_numpy(w).to(cuda)
    ct, it = (torch.from_numpy(a).to(cuda) for a in (counts, indices))
    work = torch.ones((5, 1), dtype=torch.int32, device=cuda)
    bad_grouped = [
        (xt.cpu(), wt.cpu(), ct.cpu(), it.cpu(), work.cpu(), 16, 32),
        (xt, wt, ct, it, work.cpu(), 16, 32),               # mixed devices
        (xt.half(), wt.half(), ct, it, work, 16, 32),       # dtype
        (xt, wt.bfloat16(), ct, it, work, 16, 32),          # mixed dtypes
        (xt, wt, ct.long(), it, work, 16, 32),              # plan dtype
        (xt, wt, ct, it, work.long(), 16, 32),              # work dtype
        (xt, wt, ct, it, work, 48, 32),                     # block
        (xt[:, :, :32], wt, ct, it, work, 16, 32),          # shapes
        (xt, wt, ct[:-1], it[:-1], work, 16, 32),           # plan shape
        (xt, wt, ct, it, work, 16, 24),                     # block_m
        (xt, wt, ct, it, work[:, :0], 16, 32),              # work shape
        (xt.transpose(1, 2).contiguous().transpose(1, 2), wt, ct, it, work,
         16, 32),                                           # layout
        (torch.zeros(xt.numel() + 1, device=cuda)[1:].view(xt.shape), wt,
         ct, it, work, 16, 32),                             # 16-byte start
        (xt, torch.zeros(wt.numel() + 1, device=cuda)[1:].view(wt.shape),
         ct, it, work, 16, 32),                             # 16-byte start
    ]
    for args in bad_grouped:
        with pytest.raises(ValueError):
            gbs_kernel.grouped_block_sparse_matmul(*args)
    xp = xt[0]
    te = torch.zeros((2,), dtype=torch.int32, device=cuda)
    bad_ragged = [
        (xp.cpu(), wt.cpu(), ct.cpu(), it.cpu(), te.cpu(), 16),
        (xp, wt, ct, it, te.cpu(), 16),                     # mixed devices
        (xp.double(), wt.double(), ct, it, te, 16),         # dtype
        (xp, wt, ct, it, te.long(), 16),                    # map dtype
        (xp[:24], wt, ct, it, te, 16),                      # M % 16
        (xp, wt, ct, it, te[:1], 16),                       # map shape
        (xp.T.contiguous().T, wt, ct, it, te, 16),          # layout
        (torch.zeros(xp.numel() + 1, device=cuda)[1:].view(xp.shape), wt,
         ct, it, te, 16),                                   # 16-byte start
        (xp, torch.zeros(wt.numel() + 1, device=cuda)[1:].view(wt.shape),
         ct, it, te, 16),                                   # 16-byte start
    ]
    for args in bad_ragged:
        with pytest.raises(ValueError):
            gbs_kernel.ragged_block_sparse_matmul(*args)


# ------------------------------------------ int8 kept tiles (kernels 5, 8, 9)

def _quant_weight(block: int, seed: int, E=None):
    """A block-masked weight (K, N), or an expert stack (E, K, N) whose
    expert 0 keeps nothing (its storage is one all-zero tile), each with
    an empty column and a tile that holds one tiny value, in f32 on the
    CPU (packed on the card by the caller)."""
    rng = np.random.default_rng(seed)
    lead = () if E is None else (E,)
    K, N = 4 * block, 3 * block
    masks = rng.random((*lead, K // block, N // block)) < 0.5
    masks[..., :, 0] = False
    masks[..., :, 1] = True
    w = (rng.standard_normal((*lead, K, N)) / np.sqrt(K)).astype(np.float32)
    w *= np.repeat(np.repeat(masks, block, -2), block, -1)
    w[..., :block, block:2 * block] = 0.0      # a tile of zeros...
    w[..., 0, block] = 1e-30                   # ...but for one tiny value
    if E is not None:
        w[0] = 0.0
    return torch.from_numpy(w)


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 37])
def test_quant_block_sparse_kernel_bitwise_to_kernel_1(cuda, block, dtype,
                                                       M):
    w = _quant_weight(block, 80).to(cuda)
    plan = pack_projection(w, block=block, quant="int8")
    wfq = serve_sparse.dequantized_weight(plan, w.shape[0]).to(dtype)
    x = torch.from_numpy(np.random.default_rng(81).standard_normal(
        (M, w.shape[0])).astype(np.float32)).to(cuda, dtype)
    counters.reset()
    y = bs_ops.quant_blocksparse_matmul(x, plan.tiles, plan.counts,
                                        plan.indices, plan.slots,
                                        plan.scales, block)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"block_sparse_quant": 1}
    y1 = bs_kernel.block_sparse_matmul(x, wfq.contiguous(), plan.counts,
                                       plan.indices, block)
    assert y.dtype == dtype and torch.equal(y, y1)
    plain = bs_ref.quant_block_sparse_matmul_ref(
        x.float(), plan.tiles, plan.counts, plan.indices, plan.slots,
        plan.scales, block)
    _close(y, plain, dtype)
    assert not y[:, :block].any(), "the empty column gives zeros"
    # the per-expert loop's case: slots into a longer, shared tile array
    stack = serve_sparse.pack_expert_projection(
        _quant_weight(block, 82, E=3).to(cuda), block=block, quant="int8")
    view = stack.expert(2)
    y_e = sparse_linear(x, None, view, quant="int8")
    w_e = serve_sparse.dequantized_weight(stack, w.shape[0])[2].to(dtype)
    assert torch.equal(y_e, sparse_linear(x, w_e, view, quant="none"))


@pytest.mark.parametrize("block", [16, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M", [1, 16, 37])
def test_quant_grouped_and_ragged_kernels_bitwise_to_6_and_7(cuda, block,
                                                             dtype, M):
    E = 5
    stack = serve_sparse.pack_expert_projection(
        _quant_weight(block, 83, E=E).to(cuda), block=block, ragged=True,
        quant="int8")
    K = 4 * block
    wfq = serve_sparse.dequantized_weight(stack, K).to(dtype)
    rng = np.random.default_rng(84)
    xs = torch.from_numpy(rng.standard_normal((E, M, K)).astype(
        np.float32)).to(cuda, dtype)
    live = torch.from_numpy(rng.random((E, M)) < 0.7).to(cuda)
    live[3] = False
    counters.reset()
    yg = serve_sparse.grouped_sparse_linear(xs, None, stack,
                                            row_live=live, quant="int8")
    torch.cuda.synchronize()
    launches = counters.snapshot()
    assert launches["grouped_block_sparse_quant"] == 1
    assert launches["grouped_block_sparse_quant_experts_computed"] <= E
    yg6 = serve_sparse.grouped_sparse_linear(xs, wfq, stack, row_live=live,
                                             quant="none")
    assert yg.dtype == dtype and torch.equal(yg, yg6)
    plain = gbs_ref.grouped_block_sparse_matmul_ref(
        xs.float(), wfq.float(), gbs_ref.block_masks_from_plans(
            stack.counts, stack.indices, K // block), block, block)
    rows = live[..., None].expand_as(yg)
    _close(yg[rows], plain[rows], dtype)
    assert not yg[0].any() and not yg[3].any()
    tile_expert = torch.tensor([1, 1, 4, 0, 2, -1], dtype=torch.int32,
                               device=cuda)
    xp = torch.from_numpy(rng.standard_normal((16 * 6, K)).astype(
        np.float32)).to(cuda, dtype)
    counters.reset()
    yr = serve_sparse.ragged_sparse_linear(xp, None, tile_expert, stack,
                                           quant="int8")
    torch.cuda.synchronize()
    assert counters.snapshot() == {
        "grouped_block_sparse_ragged_quant": 1,
        "grouped_block_sparse_ragged_quant_experts_computed": 4}
    yr7 = serve_sparse.ragged_sparse_linear(xp, wfq, tile_expert, stack,
                                            quant="none")
    assert torch.equal(yr, yr7)
    _close(yr, gbs_ref.ragged_block_sparse_matmul_ref(
        xp.float(), wfq.float(), tile_expert, 16,
        gbs_ref.block_masks_from_plans(stack.counts, stack.indices,
                                       K // block), block, block), dtype)
    assert not yr[80:].any() and not yr[48:64].any()


def test_quant_moe_paths_bitwise_equal_on_the_card(cuda):
    """int8: ragged == grouped == per-expert loop (kernel 5 on absolute
    slots) bitwise, and equal to the dequantised "none" paths."""
    spec, params, _ = _moe_layer(cuda, seed=75)
    packed = {(0, nm): serve_sparse.pack_expert_projection(
        params[nm], block=16, ragged=True, quant="int8")
        for nm in ("gate", "up", "down")}
    fq = {nm: serve_sparse.dequantized_weight(
        packed[(0, nm)], params[nm].shape[1]).reshape(params[nm].shape)
        for nm in ("gate", "up", "down")}
    bp = {"moe": {**params, **fq}}
    x = torch.from_numpy(np.random.default_rng(76).standard_normal(
        (4, 1, 64)).astype(np.float32)).to(cuda)
    out = {}
    for name, kw, kernel_name in (
            ("ragged", {"ragged_moe": True},
             "grouped_block_sparse_ragged_quant"),
            ("grouped", {"ragged_moe": False}, "grouped_block_sparse_quant"),
            ("loop", {"ragged_moe": False, "group_experts": False},
             "block_sparse_quant")):
        for quant in ("int8", "none"):
            counters.reset()
            out[name, quant] = serve_sparse.sparse_apply_moe(
                bp, spec, x, packed, 0, quant=quant, **kw)
            torch.cuda.synchronize()
            launches = counters.snapshot()
            if quant == "int8":
                want = 3 * (spec.n_experts if name == "loop" else 1)
                assert launches[kernel_name] == want, (name, launches)
    ref_ = out["ragged", "int8"]
    for key, y in out.items():
        assert torch.equal(y, ref_), key


def test_quant_kernels_raise_on_what_they_do_not_take(cuda):
    w = _quant_weight(16, 85).to(cuda)
    p = pack_projection(w, block=16, quant="int8")
    x = torch.zeros((16, w.shape[0]), device=cuda)
    ok = (x, p.tiles, p.counts, p.indices, p.slots, p.scales, 16)
    bad = [
        (x, p.tiles.float(), *ok[2:]),                      # float tiles
        (x, p.tiles, p.counts, p.indices, p.slots, p.scales.double(), 16),
        (x, p.tiles, p.counts, p.indices, p.slots.long(), p.scales, 16),
        (x, p.tiles.cpu(), *ok[2:]),                        # CPU/CUDA mix
        (x, p.tiles, p.counts, p.indices, p.slots, p.scales.cpu(), 16),
        (x.cpu(), *ok[1:]),
        (x.half(), *ok[1:]),                                # x dtype
        (x, p.tiles[:, :8], *ok[2:]),                       # tile shape
        (x, p.tiles, p.counts, p.indices, p.slots[:, :1], p.scales, 16),
        (x, *ok[1:6], 32),                                  # block
    ]
    for args in bad:
        with pytest.raises(ValueError):
            bs_kernel.quant_block_sparse_matmul(*args)
    s = serve_sparse.pack_expert_projection(
        _quant_weight(16, 86, E=3).to(cuda), block=16, quant="int8")
    xs = torch.zeros((3, 16, w.shape[0]), device=cuda)
    work = torch.ones((3, 1), dtype=torch.int32, device=cuda)
    te = torch.zeros((1,), dtype=torch.int32, device=cuda)
    off = torch.zeros(s.tiles.numel() + 1, dtype=torch.int8,
                      device=cuda)[1:].view(s.tiles.shape)
    for tiles, scales, xx in ((s.tiles.float(), s.scales, xs),
                              (s.tiles, s.scales.half(), xs),
                              (s.tiles.cpu(), s.scales, xs),
                              (s.tiles, s.scales, xs.cpu()),
                              (off, s.scales, xs)):     # 16-byte start
        with pytest.raises(ValueError):
            gbs_kernel.quant_grouped_block_sparse_matmul(
                xx, tiles, s.counts, s.indices, s.slots, scales, work, 16,
                16)
        with pytest.raises(ValueError):
            gbs_kernel.quant_ragged_block_sparse_matmul(
                xx[0], tiles, s.counts, s.indices, s.slots, scales, te, 16)


# ------------------------------------------------------- SSD scan (Mamba)

def _ssd_case(B, L, H, P, N, seed, h0, dtype, cuda):
    """xt (B, L, H, P), da (B, L, H) f32 <= 0, and Bm, Cm as strided
    slices of one (B, L, H * P + 2N) conv output, as the mixer passes
    them; h0 random or None."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (B, L, H * P + 2 * N)).astype(np.float32)).to(cuda, dtype)
    xt = torch.from_numpy(rng.standard_normal(
        (B, L, H, P)).astype(np.float32)).to(cuda, dtype)
    da = torch.from_numpy(-np.abs(rng.standard_normal(
        (B, L, H))).astype(np.float32) * 0.5).to(cuda)
    hs = (torch.from_numpy(rng.standard_normal(
        (B, H, P, N)).astype(np.float32)).to(cuda) if h0 else None)
    di = H * P
    return xt, da, xbc[..., di:di + N], xbc[..., di + N:], hs


# (B, L, H, P, N, chunk): the smoke mixer's shape (one chunk, a ragged
# tail), mamba2's (L a multiple of the chunk, and 600: two full chunks
# and a padded third), mamba2's served layer 0 (45 kept heads, 4096
# tokens), a chunk below one 64-row tile with P 48 (16-column slices), a
# single token, and N 5 (B and C rows element by element)
SSD_SHAPES = [(2, 37, 8, 16, 16, 8), (3, 64, 4, 32, 16, 64),
              (1, 512, 64, 64, 128, 256), (1, 600, 64, 64, 128, 256),
              (1, 4096, 45, 64, 128, 256), (2, 100, 3, 48, 40, 48),
              (1, 1, 4, 16, 16, 256), (1, 70, 2, 32, 5, 16)]


@pytest.mark.parametrize("shape", SSD_SHAPES)
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(cuda, shape, h0, dtype):
    B, L, H, P, N, chunk = shape
    xt, da, Bm, Cm, hs = _ssd_case(B, L, H, P, N, 60 + L, h0, dtype, cuda)
    assert Bm.stride(1) == H * P + 2 * N, "read in place, by stride"
    counters.reset()
    y, h = ssd_ops.ssd_scan(xt, da, Bm, Cm, chunk, hs)
    y2, h2 = ssd_ops.ssd_scan(xt, da, Bm, Cm, chunk, hs)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"ssd_scan": 2}
    assert torch.equal(y, y2) and torch.equal(h, h2)
    assert y.shape == xt.shape and y.dtype == dtype
    assert h.shape == (B, H, P, N) and h.dtype == torch.float32
    y_p, h_p = ssd_ref.ssd_chunked(xt, da, Bm, Cm, chunk, hs)
    # f32: summation order; bf16: the plain version rounds the scores
    # and both output terms to bf16 (as JAX does), the kernel once, and
    # the kernel multiplies the decayed xt and the carried state as bf16
    # operands; held at the largest value and as a whole (the Frobenius
    # norm of the error)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    for got, want in ((y, y_p), (h, h_p)):
        diff = got.float() - want.float()
        assert diff.abs().max().item() <= tol * max(
            1.0, want.float().abs().max().item())
        assert diff.norm().item() <= tol * want.float().norm().item()


def test_ssd_scan_kernel_raises_on_what_it_does_not_take(cuda):
    xt, da, Bm, Cm, hs = _ssd_case(1, 32, 2, 16, 8, 70, True,
                                   torch.float32, cuda)
    bad = [
        (xt.cpu(), da.cpu(), Bm.cpu(), Cm.cpu(), 8, hs.cpu()),   # device
        (xt, da, Bm, Cm.cpu(), 8, hs),                          # mixed
        (xt.half(), da, Bm.half(), Cm.half(), 8, hs),           # dtype
        (xt, da, Bm.bfloat16(), Cm, 8, hs),                     # mixed
        (xt, da.bfloat16(), Bm, Cm, 8, hs),                     # da f32
        (xt, da, Bm, Cm, 8, hs.double()),                       # h0 f32
        (xt.transpose(2, 3).contiguous().transpose(2, 3), da, Bm, Cm, 8,
         hs),                                                   # layout
        (xt, da, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm, 8,
         hs),                                                   # N stride
        (xt, da[:, :16], Bm, Cm, 8, hs),                        # shapes
        (xt, da, Bm, Cm, 8, hs[:, :1]),
        (xt[..., :8].contiguous(), da, Bm, Cm, 8, hs[..., :8, :]),  # P % 16
        (torch.zeros(xt.numel() + 1, device=cuda)[1:].view(xt.shape), da,
         Bm, Cm, 8, hs),                                        # 16 bytes
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ssd_kernel.ssd_scan(*args)
    long = _ssd_case(1, 300, 2, 16, 8, 71, False, torch.float32, cuda)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(*long[:4], 300)                     # chunk
    wide = _ssd_case(1, 32, 2, 16, 136, 72, False, torch.float32, cuda)
    with pytest.raises(ValueError):
        ssd_kernel.ssd_scan(*wide[:4], 8)                       # N


def test_mamba_prefill_reaches_the_kernel_and_decode_does_not(cuda):
    """Every multi-token Mamba call launches kernel 10 once per layer;
    a decode step runs the recurrence in plain torch. The prefill's
    logits and states agree with stepping the prompt token by token."""
    spec = MambaSpec(d_inner=128, d_state=32, head_dim=32, chunk=16)
    cfg = ModelConfig(name="t", d_model=64, vocab=256,
                      pattern=(LayerSpec(spec, None),), n_periods=3,
                      vocab_pad_multiple=16, scan_layers=False, remat=False)
    params = T.init_model(torch.Generator(device=cuda).manual_seed(0), cfg)
    toks = torch.randint(0, 256, (2, 40), device=cuda,
                         generator=torch.Generator(device=cuda).manual_seed(1))
    f32 = dict(compute_dtype=torch.float32)
    cache = T.init_cache(cfg, 2, 40, torch.float32, cuda)
    counters.reset()
    logits, cache, _ = T.forward(params, cfg, toks, cache=cache,
                                 cache_index=0, **f32)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"ssd_scan": cfg.n_layers}
    step = T.init_cache(cfg, 2, 40, torch.float32, cuda)
    counters.reset()
    for i in range(40):
        li, step, _ = T.forward(params, cfg, toks[:, i:i + 1], cache=step,
                                cache_index=i, **f32)
    torch.cuda.synchronize()
    assert counters.snapshot() == {}
    assert (li[:, -1] - logits[:, -1]).abs().max().item() <= 1e-3
    for a, b in zip(cache, step):
        sa, sb = a["mamba"]["state"], b["mamba"]["state"]
        assert (sa - sb).abs().max().item() <= 1e-4 * max(
            1.0, sb.abs().max().item())


def _gram(n: int, cin: int, seed: int):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, cin))
         * np.linspace(0.2, 3.0, cin)).astype(np.float32)
    return X, X.T @ X


@pytest.mark.parametrize("target", [0.5, 0.7])
def test_sparsegpt_on_the_card_matches_the_cpu(cuda, target):
    """SparseGPT's column loop on the card against the same call on CPU
    tensors (three column blocks, the last partial): masks agree on >=
    99.5% of the weights (a score on the threshold may flip with an ulp
    of inv) and the reconstruction error ||XW' - XW|| within 1%."""
    from repro_torch.core.sparsegpt import sparsegpt_dense
    X, H = _gram(1024, 320, 90)
    W = np.random.default_rng(91).standard_normal((320, 256)).astype(
        np.float32)
    wg, mg = sparsegpt_dense(torch.from_numpy(W).to(cuda),
                             torch.from_numpy(H).to(cuda), target)
    wc, mc = sparsegpt_dense(torch.from_numpy(W), torch.from_numpy(H),
                             target)
    assert wg.device.type == "cuda" and wg.shape == W.shape
    assert float((mg.cpu() == mc).float().mean()) >= 0.995
    err_g = np.linalg.norm(X @ wg.cpu().numpy() - X @ W)
    err_c = np.linalg.norm(X @ wc.numpy() - X @ W)
    assert abs(err_g - err_c) <= 0.01 * err_c
