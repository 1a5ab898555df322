// Block-sparse matmuls y = x @ w for Hopper (sm_90a), visiting only the
// nonzero K-blocks of each N-block column of w: kernel 1 over a dense
// weight, kernel 5 over the plan's kept tiles stored as int8.
//
// Replaces the TPU kernels src/repro/kernels/block_sparse/kernel.py
// block_sparse_matmul (_kernel) and quant_block_sparse_matmul
// (_quant_kernel). There the plan (counts, indices, and for int8 the
// slots and scales) is scalar-prefetched, the grid's last axis walks
// max_nnz steps in order and dead steps are clamped so their copies are
// elided. Here each warp owns one (M-tile, 8- or 16-column slice) of one
// N-block column, reads counts[n] and its plan row itself, and walks only
// the live steps through a cp.async ring (block_sparse_pipe.cuh), so a
// dead step costs nothing.
//
// Layouts: x (M, K), w (K, N), y (M, N), all row-major and contiguous,
// each starting on 16 bytes; counts (N/b,) int32; indices (N/b, max_nnz)
// int32 K-block ids. Kernel 5 takes tiles (T, b, b) int8, the kept tiles
// in plan order; slots (N/b, max_nnz) int32, the storage row of each
// step; scales (N/b, max_nnz) f32, each step's pow2 factor. The plan
// block b (16, 32, 64 or 128) is both the K-block and the N-block.
//
// Numerics: f32 is plain FFMA (no TF32) with each output one fmaf chain
// over the live K-blocks in plan order, k ascending. bf16 runs on the
// tensor cores (mma.sync m16n8k16, f32 accumulation across K-blocks in
// plan order, one rounding at the end). The MoE kernels 6-9
// (grouped_block_sparse.cu) run the same routine, so a row is bitwise
// equal across kernel 1 and kernels 6-9 in both types: kernel 6 with one
// expert is kernel 1, and an MoE layer's ragged, grouped and per-expert
// loop rows are one another's. Kernel 5
// dequantises each int8 sub-tile into the tile the dense code reads
// (float(q) * 2^e, exact in f32 and bf16), so it is bitwise equal to
// kernel 1 over the dequantised weight in both types.
//
// What bounds it on the H100:
// - Decode (M <= 16 after padding): bytes. The live weight tiles are read
//   once, density * K * N * 4 bytes in f32 (2 in bf16, 1 in int8 plus 8
//   of slot and scale per live step), at 3.35 TB/s; the FLOPs are far
//   below either peak. A dense weight's 16 x 16 tile is 16 scattered
//   row pieces of 32-64 bytes, and each slice's walk is one warp's
//   serial chain: the weight streams well below the memory rate.
// - Prefill (M >= 64): operations in f32 (2 M * live area at the 67
//   TFLOP/s FFMA peak). In bf16 the bound is bytes, but every 16-column
//   slice re-reads its x K-blocks from L2 (x traffic ~ M * live K * N /
//   16 elements), which is what the time follows.
// The first design's five causes of lost time, and their repair here:
// 1. one 256-thread block per 16 x b tile, two shared loads per FMA: one
//    warp per slice with a register tile (1 or 8 rows x 4 columns a
//    lane), x and w read as float4;
// 2. scalar loads and a barrier pair per K-block, nothing overlapped:
//    16-byte cp.async copies in a per-warp ring 4-12 items deep, no
//    barrier between warps, the plan shuffled out one item ahead;
// 3. every 16-row M-tile re-read the column's weight: 64-row M-tiles from
//    M = 64 (tile_config in kernels/block_sparse/kernel.py mirrors the
//    rule), the M-tiles of a column in neighbouring warps;
// 4. bf16 on the FFMA units: mma.sync on the tensor cores;
// 5. int8 a byte a thread: one 16-byte cp.async per tile row, the
//    step's slot and scale fetched with its K-block id.
// A 128-wide column is 8-16 warps' slices, so 77 columns still fill the
// card. Tried and not kept: a thread block of four adjacent 16-column
// slices walking the merge of their plan rows, one x tile for all four
// (slower at decode, too few blocks, and for f32 at 64-row tiles; faster
// only for bf16 at 512 rows); a 2-item unrolled ring; deeper rings
// (12-24 items) at decode. Left for later: wgmma with TMA and a producer
// warp for the 64-row tiles; IMMA (int8 x int8) for kernel 5, which at
// decode is slower than kernel 1 though it reads a quarter of the bytes.
#include "block_sparse_pipe.cuh"

namespace {

namespace bsp = block_sparse_pipe;
using bsp::Config;
using bsp::kMaxWarps;

// warp g of the grid -> (column n, slice, M-tile), the M-tile fastest
template <typename T, int BN, int BM, bool kInt8>
__device__ __forceinline__ void run(const T* __restrict__ x,
                                    const T* __restrict__ w,
                                    const int8_t* __restrict__ tiles,
                                    const int* __restrict__ counts,
                                    const int* __restrict__ indices,
                                    const int* __restrict__ slots,
                                    const float* __restrict__ scales,
                                    T* __restrict__ y, int M, int K, int N,
                                    int max_nnz) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int CW = bsp::Smem<T, BM, kInt8>::kCW;
  constexpr int kSlices = BN / CW;
  const int warp = threadIdx.x >> 5;
  const long g = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const int n_mt = (M + BM - 1) / BM;
  if (g >= static_cast<long>(N / CW) * n_mt) return;
  const int mt = static_cast<int>(g % n_mt);
  const int rest = static_cast<int>(g / n_mt);
  const int sub = (rest % kSlices) * CW;
  const int n = rest / kSlices;
  const size_t row = static_cast<size_t>(n) * max_nnz;
  bsp::warp_tile<T, BN, BM, kInt8>(
      x, w, tiles, indices + row, kInt8 ? slots + row : nullptr,
      kInt8 ? scales + row : nullptr, __ldg(counts + n), y, mt * BM, M, K, N,
      n * BN + sub, sub,
      smem + warp * bsp::Smem<T, BM, kInt8>::kWarp);
}

template <typename T, int BN, int BM>
__global__ void __launch_bounds__(kMaxWarps * 32)
block_sparse_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ counts,
                    const int* __restrict__ indices, T* __restrict__ y,
                    int M, int K, int N, int max_nnz) {
  run<T, BN, BM, false>(x, w, nullptr, counts, indices, nullptr, nullptr, y,
                        M, K, N, max_nnz);
}

template <typename T, int BN, int BM>
__global__ void __launch_bounds__(kMaxWarps * 32)
quant_block_sparse_kernel(const T* __restrict__ x,
                          const int8_t* __restrict__ tiles,
                          const int* __restrict__ counts,
                          const int* __restrict__ indices,
                          const int* __restrict__ slots,
                          const float* __restrict__ scales,
                          T* __restrict__ y, int M, int K, int N,
                          int max_nnz) {
  run<T, BN, BM, true>(x, nullptr, tiles, counts, indices, slots, scales, y,
                       M, K, N, max_nnz);
}

struct Args {
  const void *x, *w, *tiles, *counts, *indices, *slots, *scales;
  void* y;
  int M, K, N, max_nnz;
};

template <typename T, int BN, int BM>
int launch_tile(const Args& a, const Config& c, cudaStream_t st) {
  const bool int8 = a.tiles != nullptr;
  // the attribute once per (T, BN, BM), at the largest block either
  // kernel may take
  static const cudaError_t attr = [] {
    constexpr int dense = bsp::Smem<T, BM, false>::kWarp;
    constexpr int quant = bsp::Smem<T, BM, true>::kWarp;
    constexpr int bytes = kMaxWarps * (dense > quant ? dense : quant);
    cudaError_t e = cudaFuncSetAttribute(
        block_sparse_kernel<T, BN, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(quant_block_sparse_kernel<T, BN, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int CW = bsp::col_width(!std::is_same<T, float>::value, BM);
  const long warps_total = static_cast<long>(a.N / CW) * ((a.M + BM - 1) / BM);
  const dim3 grid(static_cast<unsigned>((warps_total + c.warps - 1) /
                                        c.warps));
  const dim3 block(32 * c.warps);
  const T* xp = static_cast<const T*>(a.x);
  const int* cp = static_cast<const int*>(a.counts);
  const int* ip = static_cast<const int*>(a.indices);
  T* yp = static_cast<T*>(a.y);
  if (!int8) {
    block_sparse_kernel<T, BN, BM><<<grid, block, c.smem, st>>>(
        xp, static_cast<const T*>(a.w), cp, ip, yp, a.M, a.K, a.N,
        a.max_nnz);
  } else {
    quant_block_sparse_kernel<T, BN, BM><<<grid, block, c.smem, st>>>(
        xp, static_cast<const int8_t*>(a.tiles), cp, ip,
        static_cast<const int*>(a.slots), static_cast<const float*>(a.scales),
        yp, a.M, a.K, a.N, a.max_nnz);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int launch_block(const Args& a, cudaStream_t st) {
  const Config c =
      bsp::choose(a.M, !std::is_same<T, float>::value, a.tiles != nullptr);
  return c.m_tile == 16 ? launch_tile<T, BN, 16>(a, c, st)
                        : launch_tile<T, BN, 64>(a, c, st);
}

// w (dense) or tiles / slots / scales (int8, tiles != nullptr).
template <typename T>
int launch(const Args& a, int block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 16: return launch_block<T, 16>(a, st);
    case 32: return launch_block<T, 32>(a, st);
    case 64: return launch_block<T, 64>(a, st);
    case 128: return launch_block<T, 128>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// right after the launch (0 on success). The caller checks shapes:
// K % block == 0, N % block == 0, 1 <= M, max_nnz >= 1, every pointer on
// 16 bytes; for int8, every slot below the number of stored tiles.
int block_sparse_matmul_f32(const void* x, const void* w, const void* counts,
                            const void* indices, void* y, int M, int K,
                            int N, int max_nnz, int block, void* stream) {
  return launch<float>({x, w, nullptr, counts, indices, nullptr, nullptr, y,
                        M, K, N, max_nnz},
                       block, stream);
}

int block_sparse_matmul_bf16(const void* x, const void* w, const void* counts,
                             const void* indices, void* y, int M, int K,
                             int N, int max_nnz, int block, void* stream) {
  return launch<__nv_bfloat16>({x, w, nullptr, counts, indices, nullptr,
                                nullptr, y, M, K, N, max_nnz},
                               block, stream);
}

int quant_block_sparse_matmul_f32(const void* x, const void* tiles,
                                  const void* counts, const void* indices,
                                  const void* slots, const void* scales,
                                  void* y, int M, int K, int N, int max_nnz,
                                  int block, void* stream) {
  return launch<float>({x, nullptr, tiles, counts, indices, slots, scales, y,
                        M, K, N, max_nnz},
                       block, stream);
}

int quant_block_sparse_matmul_bf16(const void* x, const void* tiles,
                                   const void* counts, const void* indices,
                                   const void* slots, const void* scales,
                                   void* y, int M, int K, int N,
                                   int max_nnz, int block, void* stream) {
  return launch<__nv_bfloat16>({x, nullptr, tiles, counts, indices, slots,
                                scales, y, M, K, N, max_nnz},
                               block, stream);
}

// The tile the launch takes for (M, bf16, int8): out = {M-tile rows,
// ring stages, warps per thread block, 0 FFMA / 1 mma.sync, dynamic
// shared bytes per block}. Lets a caller hold the Python mirror to it.
int block_sparse_tile_config(int M, int bf16, int int8, int* out) {
  const Config c = bsp::choose(M, bf16 != 0, int8 != 0);
  out[0] = c.m_tile;
  out[1] = c.stages;
  out[2] = c.warps;
  out[3] = c.mma;
  out[4] = c.smem;
  return 0;
}

}  // extern "C"
