// Block-sparse matmul y = x @ w for Hopper (sm_90a), visiting only the
// nonzero K-blocks of each N-block column of w.
//
// Replaces the TPU kernel src/repro/kernels/block_sparse/kernel.py
// (block_sparse_matmul / _kernel). There the plan (counts, indices) is
// scalar-prefetched, the grid's last axis walks max_nnz steps in order
// and dead steps are clamped so their copies are elided. Here one thread
// block owns one (16-row M-tile, N-block column) output tile: it reads
// counts[n] and indices[n, :counts[n]] from global memory itself and its
// loop stops at the last live step, so a dead step costs nothing.
//
// Layouts: x (M, K), w (K, N), y (M, N), all row-major and contiguous;
// counts (N/b,) int32; indices (N/b, max_nnz) int32 K-block ids. The
// plan block b is both the K-block and the N-block (16 in the
// golden-smoke recipe, 128 by default); any b in {16, 32, 64, 128} is
// taken, and the thread tile is derived from b, not fixed to 128.
//
// Numerics: f32 inputs are multiplied with plain FFMA (no TF32), bf16
// inputs are widened to f32 on load; the sum is kept in f32 registers,
// one K-block after another in plan order, and written once per output
// tile (a column with count 0 writes zeros). The tile routine lives in
// block_sparse_tile.cuh, shared with the grouped and ragged MoE kernels.
//
// Bound on the H100: at decode (M = 16 after padding) the kernel must
// read the live weight tiles once, density * K * N * 4 bytes in f32, at
// 3.35 TB/s; the FLOPs (2 * M * live tile area) are far below the FFMA
// peak, so it is bound by bytes. What this simple design leaves on the
// table: loads are scalar (no 16-byte vectors, no cp.async or TMA), a
// K-block's load is not overlapped with the previous block's FMAs, at
// prefill each M-tile re-reads the weight tiles (from L2 when it can),
// and bf16 runs on the FFMA units instead of the tensor cores (wgmma).
#include "block_sparse_tile.cuh"

namespace {

using block_sparse_tile::kRows;
using block_sparse_tile::kThreads;

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
block_sparse_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ counts,
                    const int* __restrict__ indices, T* __restrict__ y,
                    int M, int K, int N, int max_nnz) {
  const int n = blockIdx.x;
  block_sparse_tile::tile<T, BN>(
      x, w, indices + static_cast<size_t>(n) * max_nnz, counts[n], y,
      blockIdx.y * kRows, M, K, N, static_cast<size_t>(n) * BN);
}

template <typename T>
int launch(const void* x, const void* w, const void* counts,
           const void* indices, void* y, int M, int K, int N, int max_nnz,
           int block, void* stream) {
  const dim3 grid(N / block, (M + kRows - 1) / kRows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const int* cp = static_cast<const int*>(counts);
  const int* ip = static_cast<const int*>(indices);
  T* yp = static_cast<T*>(y);
  switch (block) {
    case 16:
      block_sparse_kernel<T, 16><<<grid, kThreads, 0, st>>>(
          xp, wp, cp, ip, yp, M, K, N, max_nnz);
      break;
    case 32:
      block_sparse_kernel<T, 32><<<grid, kThreads, 0, st>>>(
          xp, wp, cp, ip, yp, M, K, N, max_nnz);
      break;
    case 64:
      block_sparse_kernel<T, 64><<<grid, kThreads, 0, st>>>(
          xp, wp, cp, ip, yp, M, K, N, max_nnz);
      break;
    case 128:
      block_sparse_kernel<T, 128><<<grid, kThreads, 0, st>>>(
          xp, wp, cp, ip, yp, M, K, N, max_nnz);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// right after the launch (0 on success). The caller checks shapes:
// K % block == 0, N % block == 0, 1 <= M, max_nnz >= 1.
int block_sparse_matmul_f32(const void* x, const void* w, const void* counts,
                            const void* indices, void* y, int M, int K,
                            int N, int max_nnz, int block, void* stream) {
  return launch<float>(x, w, counts, indices, y, M, K, N, max_nnz, block,
                       stream);
}

int block_sparse_matmul_bf16(const void* x, const void* w, const void* counts,
                             const void* indices, void* y, int M, int K,
                             int N, int max_nnz, int block, void* stream) {
  return launch<__nv_bfloat16>(x, w, counts, indices, y, M, K, N, max_nnz,
                               block, stream);
}

}  // extern "C"
