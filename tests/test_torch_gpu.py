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
