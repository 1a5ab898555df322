"""The port's kernels against the JAX package.

On the CPU each port op runs its plain version, which is held against the
Pallas kernel in interpret mode and against the jnp references, on the
same inputs made with numpy. The kernels themselves are held against
their plain versions on the card in ``test_torch_gpu.py``.
"""
import os
import sys
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
from repro_torch.kernels.grouped_block_sparse import kernel as gbs_kernel
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


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("M", [1, 16, 64, 128, 3072])
def test_block_sparse_tile_config(block, M):
    """The tile rule of kernels 1 and 5, readable without a card: 16-row
    M-tiles at decode, 64-row ones from M = 64; 8-column warp slices for
    f32 at 16 rows, 16-column ones otherwise; FFMA in f32, mma.sync in
    bf16; the ring and its thread block within the H100's 227 KB of
    shared memory."""
    for dtype in bs_kernel.DTYPES:
        bf16 = dtype == torch.bfloat16
        for weight in ("dense", "int8"):
            c = bs_kernel.tile_config(M, block, dtype, weight)
            assert c["m_tile"] == (16 if M < 64 else 64)
            width = 8 if M < 64 and not bf16 else 16
            assert c["col_width"] == width
            assert c["slices"] == block // width
            assert c["mma"] == ("mma.sync" if bf16 else "ffma")
            deep = 12 if weight == "int8" else 8
            assert c["stages"] == (deep if M < 64 else 6 if bf16 else 4)
            assert c["warps"] == (4 if bf16 and M < 64 else 2)
            assert 0 < c["smem_bytes"] <= 227 * 1024
    with pytest.raises(ValueError):
        bs_kernel.tile_config(16, 48, torch.float32)


def _grouped_tile_rows(M: int, block_m: int, m_tile: int) -> list:
    """``(first row, end row)`` of every M-tile of a grouped launch, as
    the kernels cut it (``Tiles`` in csrc/grouped_block_sparse.cu): panel
    by panel, ``m_tile`` rows each, a panel's last tile cut at its end."""
    return [(p + t, min(p + t + m_tile, p + block_m))
            for p in range(0, M, block_m)
            for t in range(0, block_m, m_tile)]


@pytest.mark.parametrize("block", [16, 32, 64, 128])
@pytest.mark.parametrize("M,block_m", [(16, 16), (48, 16), (48, 48),
                                       (64, 64), (160, 80), (192, 64),
                                       (240, 240), (1024, 1024),
                                       (3072, 16), (3072, 128)])
def test_grouped_block_sparse_tile_config(M, block_m, block):
    """The tile rule of kernels 6 and 8, readable without a card: kernel
    1's rule applied to a panel of block_m rows (16-row M-tiles below 64
    rows, 64-row ones from 64; one warp a slice), but for bf16 at 64-row
    tiles a block of four warps sharing one x stage; each panel cut into
    tiles that end at the panel's end, so no tile holds rows of two
    panels (a live and a dead one); the ring and its thread block within
    the H100's 227 KB, the shared-x block's merge of a K of 16384 too."""
    keys = ("stages", "warps", "mma", "col_width", "slices")
    for dtype in bs_kernel.DTYPES:
        for weight in ("dense", "int8"):
            c = gbs_kernel.tile_config(M, block_m, block, dtype, weight)
            assert c["m_tile"] == (16 if block_m < 64 else 64)
            k1 = bs_kernel.tile_config(block_m, block, dtype, weight)
            shared = dtype == torch.bfloat16 and block_m >= 64
            assert c["shared_x"] == shared
            if shared:
                assert (c["warps"], c["stages"], c["col_width"]) == (
                    gbs_kernel.SHARED_X_WARPS, gbs_kernel.SHARED_X_STAGES, 16)
                assert c["smem_bytes"] < k1["smem_bytes"]
                merge = gbs_kernel.MERGE_BYTES_PER_KBLOCK * 16384 // block
                assert c["smem_bytes"] + merge + 16 <= 227 * 1024
            else:
                assert {k: c[k] for k in keys} == {k: k1[k] for k in keys}
                assert c["smem_bytes"] == k1["smem_bytes"]
            assert c["mma"] == ("mma.sync" if dtype == torch.bfloat16
                                else "ffma")
            assert 0 < c["smem_bytes"] <= 227 * 1024
            assert c["panels"] == M // block_m
            rows = _grouped_tile_rows(M, block_m, c["m_tile"])
            assert len(rows) == c["panels"] * c["per_panel"]
            covered = np.zeros(M, int)
            for m0, m1 in rows:
                assert 0 < m1 - m0 <= c["m_tile"]
                assert m0 // block_m == (m1 - 1) // block_m, \
                    "a tile crosses a panel"
                covered[m0:m1] += 1
            assert (covered == 1).all()


@pytest.mark.parametrize("M,block_m,block,dtype,weight", [
    (48, 24, 16, torch.float32, "dense"),     # block_m not a multiple of 16
    (48, 32, 16, torch.float32, "dense"),     # block_m does not divide M
    (0, 16, 16, torch.float32, "dense"),      # no rows
    (48, 0, 16, torch.float32, "dense"),      # no panel
    (48, 16, 48, torch.float32, "dense"),     # block
    (48, 16, 16, torch.float16, "dense"),     # dtype
    (48, 16, 16, torch.float32, "int4")])     # weight
def test_grouped_block_sparse_tile_config_refuses(M, block_m, block, dtype,
                                                  weight):
    with pytest.raises(ValueError):
        gbs_kernel.tile_config(M, block_m, block, dtype, weight)


def _off_by_one(t: torch.Tensor) -> torch.Tensor:
    """A contiguous view of ``t``'s shape that starts one element past
    the start of its storage."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view(t.shape)


@pytest.mark.parametrize("operand", ["x", "w", "tiles"])
def test_grouped_kernels_refuse_views_off_16_bytes(operand):
    """The grouped kernels copy 16-byte pieces with cp.async: x, the dense
    stack and the int8 tiles must each start on 16 bytes, and a view one
    element past its storage's start is refused before any launch."""
    x = torch.zeros((2, 16, 32))
    w = torch.zeros((2, 32, 32))
    tiles = torch.zeros((3, 16, 16), dtype=torch.int8)
    quant = (tiles, None, None, (2, 32, 32))
    gbs_kernel.check_operands_aligned(x, w)
    gbs_kernel.check_operands_aligned(x, quant)
    if operand == "x":
        args = (_off_by_one(x), w)
    elif operand == "w":
        args = (x, _off_by_one(w))
    else:
        args = (x, (_off_by_one(tiles), *quant[1:]))
    with pytest.raises(ValueError, match="16 bytes"):
        gbs_kernel.check_operands_aligned(*args)


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wanda_kernel_rejects_cpu_tensors_in_count_mode(dtype):
    w, a = _wanda_case(100, 300, 10)
    with pytest.raises(ValueError, match="CUDA"):
        wm_kernel.wanda_partials(torch.from_numpy(w).to(dtype),
                                 torch.from_numpy(a), torch.tensor([1.0]))


def test_wanda_kernel_is_a_cuda_source_built_with_the_rest():
    """Kernel 2 is CUDA C++ on the ctypes route: its source is one of
    the build's, and importing its launcher needs neither triton nor
    nvcc (nothing is built until a CUDA launch)."""
    from repro_torch.kernels import build
    assert wm_kernel.SOURCE == "wanda_metric.cu"
    assert wm_kernel.SOURCE in build.SOURCES
    assert (build.CSRC / wm_kernel.SOURCE).is_file()
    assert set(wm_kernel._FN) == {torch.float32, torch.bfloat16}
    assert not wm_kernel._BOUND
    assert "triton" not in sys.modules


def test_port_has_no_triton():
    """No file of the port names triton: every kernel is CUDA C++."""
    root = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "repro_torch")
    hits = []
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(d, f)
                if "triton" in open(path).read().lower():
                    hits.append(os.path.relpath(path, root))
    assert not hits


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
