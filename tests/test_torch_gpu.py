"""The port's CUDA and Triton kernels against their plain versions, on the
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
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.kernels.wanda_metric import kernel as wm_kernel
from repro_torch.kernels.wanda_metric import ops as wm_ops
from repro_torch.kernels.wanda_metric import ref as wm_ref
from repro_torch.serve.sparse import pack_projection, sparse_linear

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    """Skips the test unless a CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


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
@pytest.mark.parametrize("M", [1, 16, 37])
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
    # f32: summation order; bf16: the kernel rounds its f32 sum once
    tol = 1e-4 if dtype == torch.float32 else 2 ** -7
    err = (y.float() - plain).abs().max().item()
    assert err <= tol * max(1.0, plain.abs().max().item())
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
    ]
    for args in bad:
        with pytest.raises(ValueError):
            bs_kernel.block_sparse_matmul(*args)


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


# f32: summation order (online softmax vs one softmax); bf16: the plain
# version rounds its probabilities and output to bf16, the kernel only its
# output, so they part by about one bf16 ulp of the largest output
ATTN_RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7}


def _attn_close(got, plain, dtype):
    err = (got.float() - plain.float()).abs().max().item()
    assert err <= ATTN_RTOL[dtype] * max(1.0, plain.float().abs().max().item())


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
    ]
    for args in bad:
        with pytest.raises(ValueError):
            pa_kernel.paged_attention(*args)


@pytest.mark.parametrize("S", [1024, 3072])
@pytest.mark.parametrize("group", [1, 3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda, S, group, dtype):
    rng = np.random.default_rng(40 + group)
    n_kv, D = 2, 128
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (1, S, h, D)).astype(np.float32)).to(cuda, dtype)
        for h in (n_kv * group, n_kv, n_kv))
    counters.reset()
    out = fa_ops.flash_attention_bshd(q, k, v)
    torch.cuda.synchronize()
    assert counters.snapshot() == {"flash_attention": 1}
    assert out.shape == q.shape and out.dtype == dtype
    _attn_close(out, fa_ref.flash_attention_ref(q, k, v), dtype)


@pytest.mark.parametrize("D", [16, 32, 64])
def test_flash_attention_kernel_head_widths(cuda, D):
    rng = np.random.default_rng(50 + D)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (2, 128, h, D)).astype(np.float32)).to(cuda) for h in (6, 2, 2))
    _attn_close(fa_kernel.flash_attention(q, k, v),
                fa_ref.flash_attention_ref(q, k, v), torch.float32)


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
    for args in bad:
        with pytest.raises(ValueError):
            fa_kernel.flash_attention(*args)
