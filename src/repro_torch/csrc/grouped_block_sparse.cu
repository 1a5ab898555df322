// Block-sparse matmuls over a stack of MoE expert weights for Hopper
// (sm_90a): the grouped kernel (all experts' capacity-slot batches in one
// launch) and the ragged kernel (routed tokens packed in 16-row per-expert
// segments, one launch), each over a dense weight stack (kernels 6 and 7)
// or over every expert's kept tiles stored as int8 (kernels 8 and 9).
//
// Replaces the TPU kernels src/repro/kernels/grouped_block_sparse/
// kernel.py: grouped_block_sparse_matmul (_kernel),
// ragged_block_sparse_matmul (_ragged_kernel),
// quant_grouped_block_sparse_matmul (_quant_kernel) and
// quant_ragged_block_sparse_matmul (_quant_ragged_kernel). There the
// stacked plan (with slots and scales for int8) and the occupancy map
// (work) or tile map (tile_expert) are scalar-prefetched, the grid's last
// axis walks max_nnz steps in order, and the
// index maps of dead steps, dead (expert, M-block) pairs and dead tiles
// are clamped so their copies are elided. None of that has a Hopper
// counterpart. Here one thread block owns one 16-row output tile of one
// N-block column and reads its own plan row, occupancy entry or owning
// expert from global memory: a dead tile writes zeros and returns, a live
// tile loops only over its live K-blocks, in plan order.
//
//   grouped: grid (N/b, M/16, E). y[e] = x[e] @ w[e]. work (E, M/block_m)
//            marks the (expert, panel) pairs that hold a routed row; a
//            tile reads the entry of the panel it lies in.
//   ragged:  grid (N/b, M/16). y[t] = x[t] @ w[tile_expert[t]] per 16-row
//            tile t; tile_expert[t] < 0 (padding past the packed total)
//            writes zeros.
//
// Layouts: x (E, M, K) or (M, K), w (E, K, N), y like x with N columns,
// all row-major and contiguous; counts (E, N/b) int32; indices (E, N/b,
// max_nnz) int32 K-block ids, edge-padded; work (E, M/block_m) int32;
// tile_expert (M/16,) int32. The int8 kernels take, instead of w, tiles
// (T, b, b) int8 (every expert's kept tiles concatenated in plan order),
// slots (E, N/b, max_nnz) int32 holding absolute storage rows and scales
// (E, N/b, max_nnz) f32 pow2 factors. The plan block b is both the
// K-block and the N-block, one of {16, 32, 64, 128}.
//
// Numerics: the tile routine of kernel 1 (block_sparse_tile.cuh): FFMA in
// f32 (no TF32), bf16 widened on load, one K-block after another in plan
// order; the int8 kernels dequantise on load (float(q) * scale, exact).
// A token's row is therefore bitwise equal whether it runs through the
// ragged kernel, the grouped kernel or kernel 1 on its expert alone, and
// the int8 kernels equal kernels 6 and 7 over the dequantised stack.
//
// Bound on the H100: both kernels are bound by bytes at decode and at
// prefill. The least the card must move is every live expert's live
// weight tiles once (density * K * N * 4 bytes per live expert in f32,
// 1 byte in int8 plus 8 bytes of slot and scale per live step), plus the
// live x rows and the output, at 3.35 TB/s; the FLOPs (2 * rows
// * live tile area per expert) sit far below the FFMA peak at the 16-48
// rows an expert sees here. What this simple design leaves on the table:
// scalar loads (no 16-byte vectors, no cp.async or TMA pipeline; int8
// tiles a byte a thread), no wgmma for bf16 and no IMMA for int8, a whole
// thread block for a 16-row tile whose rows may be mostly padding, and
// the x panel re-read for every N-block column (from L2 when it can); a
// grouped panel taller than 16 rows re-reads each live weight tile once
// per 16-row tile.
#include "block_sparse_tile.cuh"

namespace {

using block_sparse_tile::DenseWeight;
using block_sparse_tile::Int8Tiles;
using block_sparse_tile::kRows;
using block_sparse_tile::kThreads;

// The weight source of a column whose stacked plan row is `plan`: the
// dense (E, K, N) stack `w` (kernels 6, 7: DenseStack, no state), or the
// int8 storage with absolute slots (kernels 8, 9: w is nullptr).
struct DenseStack {
  static constexpr bool kDense = true;

  __device__ __forceinline__ DenseWeight at(size_t /*plan*/,
                                            int /*max_nnz*/) const {
    return {};
  }
};

template <int BN>
struct Int8Stack {
  static constexpr bool kDense = false;
  const int8_t* tiles;
  const int* slots;
  const float* scales;

  __device__ __forceinline__ Int8Tiles<BN> at(size_t plan,
                                              int max_nnz) const {
    const size_t row = plan * max_nnz;
    return {tiles, slots + row, scales + row};
  }
};

template <typename T, int BN, typename S>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const T* __restrict__ x, const T* __restrict__ w, S ws,
               const int* __restrict__ counts,
               const int* __restrict__ indices,
               const int* __restrict__ work, T* __restrict__ y, int M, int K,
               int N, int max_nnz, int block_m) {
  const int n = blockIdx.x;
  const int m0 = blockIdx.y * kRows;
  const int e = blockIdx.z;
  const size_t col0 = static_cast<size_t>(n) * BN;
  T* ye = y + static_cast<size_t>(e) * M * N;
  if (work[e * (M / block_m) + m0 / block_m] <= 0) {
    block_sparse_tile::zero_tile<T, BN>(ye, m0, M, N, col0);
    return;
  }
  const size_t plan = static_cast<size_t>(e) * (N / BN) + n;
  block_sparse_tile::tile<T, BN>(
      x + static_cast<size_t>(e) * M * K,
      S::kDense ? w + static_cast<size_t>(e) * K * N : nullptr,
      ws.at(plan, max_nnz), indices + plan * max_nnz, counts[plan], ye, m0,
      M, K, N, col0);
}

template <typename T, int BN, typename S>
__global__ void __launch_bounds__(kThreads)
ragged_kernel(const T* __restrict__ x, const T* __restrict__ w, S ws,
              const int* __restrict__ counts,
              const int* __restrict__ indices,
              const int* __restrict__ tile_expert, T* __restrict__ y, int M,
              int K, int N, int E, int max_nnz) {
  const int n = blockIdx.x;
  const int t = blockIdx.y;
  const size_t col0 = static_cast<size_t>(n) * BN;
  const int e = tile_expert[t];
  if (e < 0 || e >= E) {
    block_sparse_tile::zero_tile<T, BN>(y, t * kRows, M, N, col0);
    return;
  }
  const size_t plan = static_cast<size_t>(e) * (N / BN) + n;
  block_sparse_tile::tile<T, BN>(
      x, S::kDense ? w + static_cast<size_t>(e) * K * N : nullptr,
      ws.at(plan, max_nnz), indices + plan * max_nnz, counts[plan], y,
      t * kRows, M, K, N, col0);
}

// The pointers of one launch: w (dense) or tiles / slots / scales (int8,
// tiles != nullptr), and the plan with its occupancy map (`map`: work
// for the grouped kernel, tile_expert for the ragged one).
struct Args {
  const void* x;
  const void* w;
  const void* tiles;
  const void* slots;
  const void* scales;
  const int* counts;
  const int* indices;
  const int* map;
  void* y;
};

template <typename T, int BN, typename S>
void launch_source(const Args& a, S ws, bool ragged, int E, int M, int K,
                   int N, int max_nnz, int block_m, cudaStream_t st) {
  const T* xp = static_cast<const T*>(a.x);
  const T* wp = static_cast<const T*>(a.w);
  T* yp = static_cast<T*>(a.y);
  if (ragged) {
    const dim3 grid(N / BN, M / kRows);
    ragged_kernel<T, BN, S><<<grid, kThreads, 0, st>>>(
        xp, wp, ws, a.counts, a.indices, a.map, yp, M, K, N, E, max_nnz);
  } else {
    const dim3 grid(N / BN, (M + kRows - 1) / kRows, E);
    grouped_kernel<T, BN, S><<<grid, kThreads, 0, st>>>(
        xp, wp, ws, a.counts, a.indices, a.map, yp, M, K, N, max_nnz,
        block_m);
  }
}

template <typename T, int BN>
void launch_block(const Args& a, bool ragged, int E, int M, int K, int N,
                  int max_nnz, int block_m, cudaStream_t st) {
  if (a.tiles == nullptr) {
    launch_source<T, BN>(a, DenseStack{}, ragged, E, M, K, N, max_nnz,
                         block_m, st);
  } else {
    launch_source<T, BN>(
        a, Int8Stack<BN>{static_cast<const int8_t*>(a.tiles),
                         static_cast<const int*>(a.slots),
                         static_cast<const float*>(a.scales)},
        ragged, E, M, K, N, max_nnz, block_m, st);
  }
}

template <typename T>
int launch(const Args& a, bool ragged, int E, int M, int K, int N,
           int max_nnz, int block, int block_m, void* stream) {
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ragged ? M % kRows != 0
             : (block_m <= 0 || M % block_m || block_m % kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 16:
      launch_block<T, 16>(a, ragged, E, M, K, N, max_nnz, block_m, st);
      break;
    case 32:
      launch_block<T, 32>(a, ragged, E, M, K, N, max_nnz, block_m, st);
      break;
    case 64:
      launch_block<T, 64>(a, ragged, E, M, K, N, max_nnz, block_m, st);
      break;
    case 128:
      launch_block<T, 128>(a, ragged, E, M, K, N, max_nnz, block_m, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int grouped(const void* x, const void* w, const void* tiles,
            const void* slots, const void* scales, const void* counts,
            const void* indices, const void* work, void* y, int E, int M,
            int K, int N, int max_nnz, int block, int block_m,
            void* stream) {
  const Args a{x, w, tiles, slots, scales, static_cast<const int*>(counts),
               static_cast<const int*>(indices),
               static_cast<const int*>(work), y};
  return launch<T>(a, false, E, M, K, N, max_nnz, block, block_m, stream);
}

template <typename T>
int ragged(const void* x, const void* w, const void* tiles,
           const void* slots, const void* scales, const void* counts,
           const void* indices, const void* tile_expert, void* y, int M,
           int K, int N, int E, int max_nnz, int block, void* stream) {
  const Args a{x, w, tiles, slots, scales, static_cast<const int*>(counts),
               static_cast<const int*>(indices),
               static_cast<const int*>(tile_expert), y};
  return launch<T>(a, true, E, M, K, N, max_nnz, block, kRows, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// right after the launch (0 on success). The caller checks shapes:
// K % block == 0, N % block == 0, max_nnz >= 1; grouped: M % block_m == 0
// and block_m % 16 == 0; ragged: M % 16 == 0; int8: every slot below the
// number of stored tiles.
int grouped_block_sparse_matmul_f32(const void* x, const void* w,
                                    const void* counts, const void* indices,
                                    const void* work, void* y, int E, int M,
                                    int K, int N, int max_nnz, int block,
                                    int block_m, void* stream) {
  return grouped<float>(x, w, nullptr, nullptr, nullptr, counts, indices,
                        work, y, E, M, K, N, max_nnz, block, block_m,
                        stream);
}

int grouped_block_sparse_matmul_bf16(const void* x, const void* w,
                                     const void* counts, const void* indices,
                                     const void* work, void* y, int E, int M,
                                     int K, int N, int max_nnz, int block,
                                     int block_m, void* stream) {
  return grouped<__nv_bfloat16>(x, w, nullptr, nullptr, nullptr, counts,
                                indices, work, y, E, M, K, N, max_nnz, block,
                                block_m, stream);
}

int ragged_block_sparse_matmul_f32(const void* x, const void* w,
                                   const void* counts, const void* indices,
                                   const void* tile_expert, void* y, int M,
                                   int K, int N, int E, int max_nnz,
                                   int block, void* stream) {
  return ragged<float>(x, w, nullptr, nullptr, nullptr, counts, indices,
                       tile_expert, y, M, K, N, E, max_nnz, block, stream);
}

int ragged_block_sparse_matmul_bf16(const void* x, const void* w,
                                    const void* counts, const void* indices,
                                    const void* tile_expert, void* y, int M,
                                    int K, int N, int E, int max_nnz,
                                    int block, void* stream) {
  return ragged<__nv_bfloat16>(x, w, nullptr, nullptr, nullptr, counts,
                               indices, tile_expert, y, M, K, N, E, max_nnz,
                               block, stream);
}

int quant_grouped_block_sparse_matmul_f32(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* work, void* y, int E, int M, int K, int N, int max_nnz,
    int block, int block_m, void* stream) {
  return grouped<float>(x, nullptr, tiles, slots, scales, counts, indices,
                        work, y, E, M, K, N, max_nnz, block, block_m,
                        stream);
}

int quant_grouped_block_sparse_matmul_bf16(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* work, void* y, int E, int M, int K, int N, int max_nnz,
    int block, int block_m, void* stream) {
  return grouped<__nv_bfloat16>(x, nullptr, tiles, slots, scales, counts,
                                indices, work, y, E, M, K, N, max_nnz, block,
                                block_m, stream);
}

int quant_ragged_block_sparse_matmul_f32(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* tile_expert, void* y, int M, int K, int N, int E,
    int max_nnz, int block, void* stream) {
  return ragged<float>(x, nullptr, tiles, slots, scales, counts, indices,
                       tile_expert, y, M, K, N, E, max_nnz, block, stream);
}

int quant_ragged_block_sparse_matmul_bf16(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* tile_expert, void* y, int M, int K, int N, int E,
    int max_nnz, int block, void* stream) {
  return ragged<__nv_bfloat16>(x, nullptr, tiles, slots, scales, counts,
                               indices, tile_expert, y, M, K, N, E, max_nnz,
                               block, stream);
}

}  // extern "C"
