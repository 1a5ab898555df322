// Block-sparse matmuls y = x @ w for Hopper (sm_90a), visiting only the
// nonzero K-blocks of each N-block column of w: kernel 1 over a dense
// weight, kernel 5 over the plan's kept tiles stored as int8.
//
// Replaces the TPU kernels src/repro/kernels/block_sparse/kernel.py
// block_sparse_matmul (_kernel) and quant_block_sparse_matmul
// (_quant_kernel). There the plan (counts, indices, and for int8 the
// slots and scales) is scalar-prefetched, the grid's last axis walks
// max_nnz steps in order and dead steps are clamped so their copies are
// elided. Here one thread block owns one (16-row M-tile, N-block column)
// output tile: it reads counts[n] and its plan row from global memory
// itself and its loop stops at the last live step, so a dead step costs
// nothing.
//
// Layouts: x (M, K), w (K, N), y (M, N), all row-major and contiguous;
// counts (N/b,) int32; indices (N/b, max_nnz) int32 K-block ids. Kernel
// 5 takes tiles (T, b, b) int8, the kept tiles in plan order; slots
// (N/b, max_nnz) int32, the storage row of each step; scales (N/b,
// max_nnz) f32, each step's pow2 factor. The plan block b is both the
// K-block and the N-block (16 in the golden-smoke recipe, 128 by
// default); any b in {16, 32, 64, 128} is taken, and the thread tile is
// derived from b, not fixed to 128.
//
// Numerics: f32 inputs are multiplied with plain FFMA (no TF32), bf16
// inputs are widened to f32 on load; the sum is kept in f32 registers,
// one K-block after another in plan order, and written once per output
// tile (a column with count 0 writes zeros). Kernel 5 dequantises each
// int8 weight into the staged tile as float(q) * scale, which is exact,
// so it is bitwise equal to kernel 1 over the dequantised weight. The
// tile routine lives in block_sparse_tile.cuh, shared with the grouped
// and ragged MoE kernels.
//
// Bound on the H100: at decode (M = 16 after padding) the kernel must
// read the live weight tiles once, density * K * N * 4 bytes in f32
// (1 byte in int8, plus 8 bytes of slot and scale per live step), at
// 3.35 TB/s; the FLOPs (2 * M * live tile area) are far below the FFMA
// peak, so it is bound by bytes. What this simple design leaves on the
// table: loads are scalar (no 16-byte vectors, no cp.async or TMA; int8
// tiles are read a byte a thread), a K-block's load is not overlapped
// with the previous block's FMAs, at prefill each M-tile re-reads the
// weight tiles (from L2 when it can), and bf16 and int8 run on the FFMA
// units instead of the tensor cores (wgmma, or IMMA for int8).
#include "block_sparse_tile.cuh"

namespace {

using block_sparse_tile::DenseWeight;
using block_sparse_tile::Int8Tiles;
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
      x, w, DenseWeight{}, indices + static_cast<size_t>(n) * max_nnz,
      counts[n], y, blockIdx.y * kRows, M, K, N,
      static_cast<size_t>(n) * BN);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kThreads)
quant_block_sparse_kernel(const T* __restrict__ x,
                          const int8_t* __restrict__ tiles,
                          const int* __restrict__ counts,
                          const int* __restrict__ indices,
                          const int* __restrict__ slots,
                          const float* __restrict__ scales,
                          T* __restrict__ y, int M, int K, int N,
                          int max_nnz) {
  const int n = blockIdx.x;
  const size_t row = static_cast<size_t>(n) * max_nnz;
  block_sparse_tile::tile<T, BN>(
      x, nullptr, Int8Tiles<BN>{tiles, slots + row, scales + row},
      indices + row, counts[n], y, blockIdx.y * kRows, M, K, N,
      static_cast<size_t>(n) * BN);
}

template <typename T, int BN>
void launch_block(const void* x, const void* w, const void* tiles,
                  const void* counts, const void* indices, const void* slots,
                  const void* scales, void* y, int M, int K, int N,
                  int max_nnz, cudaStream_t st) {
  const dim3 grid(N / BN, (M + kRows - 1) / kRows);
  const T* xp = static_cast<const T*>(x);
  const int* cp = static_cast<const int*>(counts);
  const int* ip = static_cast<const int*>(indices);
  T* yp = static_cast<T*>(y);
  if (tiles == nullptr) {
    block_sparse_kernel<T, BN><<<grid, kThreads, 0, st>>>(
        xp, static_cast<const T*>(w), cp, ip, yp, M, K, N, max_nnz);
  } else {
    quant_block_sparse_kernel<T, BN><<<grid, kThreads, 0, st>>>(
        xp, static_cast<const int8_t*>(tiles), cp, ip,
        static_cast<const int*>(slots), static_cast<const float*>(scales),
        yp, M, K, N, max_nnz);
  }
}

// w (dense) or tiles / slots / scales (int8, tiles != nullptr).
template <typename T>
int launch(const void* x, const void* w, const void* tiles,
           const void* counts, const void* indices, const void* slots,
           const void* scales, void* y, int M, int K, int N, int max_nnz,
           int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 16:
      launch_block<T, 16>(x, w, tiles, counts, indices, slots, scales, y, M,
                          K, N, max_nnz, st);
      break;
    case 32:
      launch_block<T, 32>(x, w, tiles, counts, indices, slots, scales, y, M,
                          K, N, max_nnz, st);
      break;
    case 64:
      launch_block<T, 64>(x, w, tiles, counts, indices, slots, scales, y, M,
                          K, N, max_nnz, st);
      break;
    case 128:
      launch_block<T, 128>(x, w, tiles, counts, indices, slots, scales, y,
                           M, K, N, max_nnz, st);
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
// K % block == 0, N % block == 0, 1 <= M, max_nnz >= 1; for int8, every
// slot below the number of stored tiles.
int block_sparse_matmul_f32(const void* x, const void* w, const void* counts,
                            const void* indices, void* y, int M, int K,
                            int N, int max_nnz, int block, void* stream) {
  return launch<float>(x, w, nullptr, counts, indices, nullptr, nullptr, y,
                       M, K, N, max_nnz, block, stream);
}

int block_sparse_matmul_bf16(const void* x, const void* w, const void* counts,
                             const void* indices, void* y, int M, int K,
                             int N, int max_nnz, int block, void* stream) {
  return launch<__nv_bfloat16>(x, w, nullptr, counts, indices, nullptr,
                               nullptr, y, M, K, N, max_nnz, block, stream);
}

int quant_block_sparse_matmul_f32(const void* x, const void* tiles,
                                  const void* counts, const void* indices,
                                  const void* slots, const void* scales,
                                  void* y, int M, int K, int N, int max_nnz,
                                  int block, void* stream) {
  return launch<float>(x, nullptr, tiles, counts, indices, slots, scales, y,
                       M, K, N, max_nnz, block, stream);
}

int quant_block_sparse_matmul_bf16(const void* x, const void* tiles,
                                   const void* counts, const void* indices,
                                   const void* slots, const void* scales,
                                   void* y, int M, int K, int N,
                                   int max_nnz, int block, void* stream) {
  return launch<__nv_bfloat16>(x, nullptr, tiles, counts, indices, slots,
                               scales, y, M, K, N, max_nnz, block, stream);
}

}  // extern "C"
