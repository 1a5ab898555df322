"""The port's kernels against the JAX package.

On the CPU each port op runs its plain version, which is held against the
Pallas kernel in interpret mode and against the jnp references, on the
same inputs made with numpy. The kernels themselves are held against
their plain versions on the card in ``test_torch_gpu.py``.
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import pod as jax_pod
from repro.core.registry import Projection as JaxProjection
from repro.kernels.block_sparse import ops as jax_bs_ops
from repro.kernels.block_sparse.ref import \
    block_sparse_matmul_ref as jax_bs_ref
from repro.kernels.wanda_metric import ops as jax_wm_ops
from repro.kernels.wanda_metric.kernel import \
    wanda_partials as jax_wanda_partials
from repro.kernels.wanda_metric.ref import \
    outlier_ratio_ref as jax_outlier_ratio_ref

from repro_torch.core import pod
from repro_torch.core.registry import Projection
from repro_torch.kernels import counters
from repro_torch.kernels.block_sparse import kernel as bs_kernel
from repro_torch.kernels.block_sparse import ops as bs_ops
from repro_torch.kernels.block_sparse import ref as bs_ref
from repro_torch.kernels.wanda_metric import kernel as wm_kernel
from repro_torch.kernels.wanda_metric import ops as wm_ops
from repro_torch.kernels.wanda_metric import ref as wm_ref

ATOL = 1e-5          # f32 sum-order noise on O(1) outputs


def _plan_case(block: int, seed: int):
    """x (M, K), block-masked w (K, N), block map with two empty columns
    and columns of different counts (so index rows are padded)."""
    rng = np.random.default_rng(seed)
    M, K, N = block, 3 * block, 4 * block
    bm = rng.random((K // block, N // block)) < 0.6
    bm[:, 0] = False
    bm[:, 2] = False
    bm[:, 1] = True
    x = rng.standard_normal((M, K)).astype(np.float32)
    # scaled so the outputs are O(1), as a layer's are
    w = (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32)
    w *= np.repeat(np.repeat(bm, block, 0), block, 1)
    return x, w, bm


@pytest.mark.parametrize("block", [16, 128])
def test_plan_blocks_matches_jax(block):
    _, w, bm = _plan_case(block, 0)
    mask_t = bs_ops.block_mask_from_weight_mask(torch.from_numpy(w != 0),
                                                block, block)
    mask_j = jax_bs_ops.block_mask_from_weight_mask(w != 0, block, block)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    np.testing.assert_array_equal(mask_t.numpy(), bm)
    counts, indices = bs_ops.plan_blocks(bm)
    counts_j, indices_j = jax_bs_ops.plan_blocks(bm)
    np.testing.assert_array_equal(counts, np.asarray(counts_j))
    np.testing.assert_array_equal(indices, np.asarray(indices_j))
    assert counts[0] == 0 and counts[1] == bm.shape[0]
    back = bs_ref.block_mask_from_plan(torch.from_numpy(counts),
                                       torch.from_numpy(indices),
                                       bm.shape[0])
    np.testing.assert_array_equal(back.numpy(), bm)


@pytest.mark.parametrize("block", [16, 128])
def test_block_sparse_plain_matches_pallas(block):
    x, w, bm = _plan_case(block, 1)
    counts, indices = bs_ops.plan_blocks(bm)
    counters.reset()
    y = bs_ops.blocksparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(counts),
                                  torch.from_numpy(indices), block)
    assert counters.snapshot().get("block_sparse", 0) == 0, \
        "the CPU path must not count a kernel launch"
    y_pallas = jax_bs_ops.blocksparse_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(counts),
        jnp.asarray(indices), block_m=block, block_k=block, block_n=block,
        interpret=True)
    y_jref = jax_bs_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bm),
                        block, block)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pallas), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_jref), atol=ATOL,
                               rtol=0)
    assert not y[:, :block].any() and not y[:, 2 * block:3 * block].any()


@pytest.mark.parametrize("block", [16, 128])
def test_block_sparse_ref_matches_jax_ref(block):
    x, w, bm = _plan_case(block, 2)
    # the plain version zeroes pruned blocks itself: feed a dense w
    w_dense = np.random.default_rng(3).standard_normal(w.shape).astype(
        np.float32)
    y = bs_ref.block_sparse_matmul_ref(torch.from_numpy(x),
                                       torch.from_numpy(w_dense),
                                       torch.from_numpy(bm), block, block)
    y_j = jax_bs_ref(jnp.asarray(x), jnp.asarray(w_dense), jnp.asarray(bm),
                     block, block)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=ATOL, rtol=0)


def test_block_sparse_kernel_rejects_cpu_tensors():
    x, w, bm = _plan_case(16, 4)
    counts, indices = (torch.from_numpy(a) for a in bs_ops.plan_blocks(bm))
    with pytest.raises(ValueError, match="CUDA"):
        bs_kernel.block_sparse_matmul(torch.from_numpy(x),
                                      torch.from_numpy(w), counts, indices,
                                      16)


def _wanda_case(K, N, seed):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    a = (rng.random(K) + 0.5).astype(np.float32)
    return w, a


@pytest.mark.parametrize("shape", [(64, 128), (256, 512), (512, 256)])
def test_outlier_ratio_plain_matches_jax(shape):
    K, N = shape
    w, a = _wanda_case(K, N, 5)
    r = float(wm_ops.outlier_ratio(torch.from_numpy(w), torch.from_numpy(a),
                                   5.0))
    # a different summation order can move the mean across one element
    tol = 2 * 100.0 / (K * N)
    r_pallas = float(jax_wm_ops.outlier_ratio(jnp.asarray(w), jnp.asarray(a),
                                              5.0, interpret=True))
    r_ref = float(jax_outlier_ratio_ref(jnp.asarray(w), jnp.asarray(a), 5.0))
    assert abs(r - r_pallas) <= tol
    assert abs(r - r_ref) <= tol
    assert 0.0 < r < 100.0


def test_outlier_ratio_matches_pod_on_folded_projections():
    """``pod.global_rank`` folds a projection to 2-D before the op; the
    ratio equals ``pod.outlier_ratio(weight_metric(...))`` on the
    unfolded weight, for in_axes (0,) and for the o-projection."""
    rng = np.random.default_rng(6)
    cases = [
        (rng.standard_normal((64, 4, 16)).astype(np.float32),
         (rng.random(64) + 0.5).astype(np.float32), (0,)),
        (rng.standard_normal((4, 16, 64)).astype(np.float32),
         (rng.random((4, 16)) + 0.5).astype(np.float32), (0, 1)),
    ]
    for w, a, in_axes in cases:
        proj = Projection(0, "x", ("x",), "t", in_axes)
        w2, a2 = pod.fold_2d(torch.from_numpy(w), torch.from_numpy(a), proj)
        assert w2.shape == (w.shape[0] * (w.shape[1] if in_axes == (0, 1)
                                          else 1), w.size // w2.shape[0])
        r = float(wm_ops.outlier_ratio(w2.contiguous(), a2, 5.0))
        jproj = JaxProjection(0, "x", ("x",), "t", in_axes)
        r_pod = float(jax_pod.outlier_ratio(
            jax_pod.weight_metric(jnp.asarray(w), jnp.asarray(a), jproj),
            5.0))
        assert abs(r - r_pod) <= 2 * 100.0 / w.size
        r_port_pod = float(pod.outlier_ratio(pod.weight_metric(
            torch.from_numpy(w), torch.from_numpy(a), proj), 5.0))
        assert abs(r - r_port_pod) <= 2 * 100.0 / w.size


@pytest.mark.parametrize("count", [False, True])
def test_wanda_partials_plain_matches_pallas(count):
    w, a = _wanda_case(256, 512, 7)
    thresh = 0.9
    t = torch.tensor([thresh]) if count else None
    part = wm_ref.wanda_partials_ref(torch.from_numpy(w), torch.from_numpy(a),
                                     t, block_k=64, block_n=128)
    part_j = jax_wanda_partials(jnp.asarray(w), jnp.asarray(a),
                                thresh if count else None, block_k=64,
                                block_n=128, interpret=True)
    assert part.shape == (4, 4)
    np.testing.assert_allclose(part.numpy(), np.asarray(part_j), rtol=1e-5,
                               atol=0)


def test_wanda_partials_plain_covers_ragged_edges():
    w, a = _wanda_case(100, 300, 8)
    part = wm_ref.wanda_partials_ref(torch.from_numpy(w), torch.from_numpy(a),
                                     block_k=64, block_n=256)
    assert part.shape == (2, 2)
    total = float(wm_ref.metric_ref(torch.from_numpy(w),
                                    torch.from_numpy(a)).sum())
    assert abs(float(part.sum()) - total) <= 1e-5 * total


def test_wanda_kernel_rejects_cpu_tensors():
    w, a = _wanda_case(64, 128, 9)
    with pytest.raises(ValueError, match="CUDA"):
        wm_kernel.wanda_partials(torch.from_numpy(w), torch.from_numpy(a))


def test_counters_reset_and_snapshot():
    counters.reset()
    counters.record("block_sparse")
    counters.record("block_sparse", 2)
    assert counters.snapshot() == {"block_sparse": 3}
    counters.reset()
    assert counters.snapshot() == {}


def test_build_dir_follows_checkout_or_override(monkeypatch, tmp_path):
    from repro_torch.kernels import build
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.delenv("REPRO_TORCH_BUILD_DIR", raising=False)
    assert build._build_dir() == Path(root) / "build" / "repro_torch"
    monkeypatch.setenv("REPRO_TORCH_BUILD_DIR", str(tmp_path))
    assert build._build_dir() == tmp_path
