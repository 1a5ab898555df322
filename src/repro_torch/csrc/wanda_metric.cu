// Wanda-metric partial reduction (POD, Eqs. 5-6) for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/wanda_metric/kernel.py
// (wanda_partials / _kernel): one grid step per (K-block, N-block) tile
// of w forms the metric |W| * ||A||_2 in VMEM and writes the tile's sum
// of it, or its count of values above a threshold. Here one thread block
// takes one (64 x 256) tile (BLOCK_K x BLOCK_N, so the partials' shape
// and every caller stay as they are) and never writes the metric to
// device memory.
//
// Bound on the H100: bytes. One read of w (4 or 2 bytes an element) at
// 3.35 TB/s; three operations an element are far below either peak. So
// each thread keeps its whole share of the tile in flight at once: 16
// (f32) or 8 (bf16) 16-byte loads, issued before any of them is used,
// 16-byte aligned rows taken whole and the ragged edge (a row's last
// partial chunk, rows past K) masked element by element, so any (K, N)
// and any row stride is taken. In count mode the threshold is read from
// its device pointer, so the mean never travels to the host between the
// two passes of ops.outlier_ratio (the TPU kernel folded it into ||A||
// because its threshold was static).
//
// The block sum runs in a fixed order: each thread's per-lane-position
// chains, then a butterfly of warp shuffles, then the warps in order. No
// atomics, so two launches give the same bits. Counts are exact (at
// most 16,384 a tile, held in f32).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;                // rows of a tile (BLOCK_K)
constexpr int kBN = 256;               // columns of a tile (BLOCK_N)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// 16 bytes of w at p as f32 values.
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 t = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 t = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned u[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(&u[i]);
    const float2 f = __bfloat1622float2(h);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Thread t owns 16-byte chunk t % kChunks of rows t / kChunks + R r of
// its tile (R = the rows one pass of the block covers): a warp reads 512
// contiguous bytes of one row.
template <typename T, bool kCount>
__global__ void __launch_bounds__(kThreads)
wanda_partials_kernel(const T* __restrict__ w,
                      const float* __restrict__ anorm,
                      const float* __restrict__ threshold,
                      float* __restrict__ out, int K, int N, long long ld,
                      int vec) {
  constexpr int kV = 16 / int(sizeof(T));      // elements per 16 bytes
  constexpr int kChunks = kBN / kV;            // chunks per tile row
  constexpr int kRows = kThreads / kChunks;    // rows per pass
  constexpr int kPasses = kBK / kRows;         // f32 16, bf16 8
  const int pk = blockIdx.y, pn = blockIdx.x;
  const int q = threadIdx.x % kChunks, r0 = threadIdx.x / kChunks;
  const int col = pn * kBN + q * kV;
  const bool whole = vec && col + kV <= N;     // the chunk in one load
  const float thr = kCount ? __ldg(threshold) : 0.f;

  float v[kPasses][kV];
  float an[kPasses];
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    const int r = pk * kBK + r0 + p * kRows;
    an[p] = r < K ? __ldg(anorm + r) : 0.f;
    const T* src = w + static_cast<size_t>(r < K ? r : 0) * ld + col;
    if (r < K && whole) {
      load16(src, v[p]);
    } else {
#pragma unroll
      for (int e = 0; e < kV; ++e)
        v[p][e] = r < K && col + e < N ? to_f32(src[e]) : 0.f;
    }
  }
  float acc[kV];
#pragma unroll
  for (int e = 0; e < kV; ++e) acc[e] = 0.f;
#pragma unroll
  for (int p = 0; p < kPasses; ++p)
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float m = fabsf(v[p][e]) * an[p];
      if constexpr (kCount)
        acc[e] += m > thr ? 1.f : 0.f;
      else
        acc[e] += m;
    }
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kV; ++e) s += acc[e];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  __shared__ float warp_sum[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) t += warp_sum[i];
    out[static_cast<size_t>(pk) * gridDim.x + pn] = t;
  }
}

template <typename T>
int launch(const void* w, const void* anorm, const void* threshold,
           void* out, int K, int N, long long ld, void* stream) {
  constexpr int kV = 16 / int(sizeof(T));
  if (K < 1 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = reinterpret_cast<uintptr_t>(w) % 16 == 0 && ld % kV == 0;
  const dim3 grid((N + kBN - 1) / kBN, (K + kBK - 1) / kBK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T* wp = static_cast<const T*>(w);
  const float* ap = static_cast<const float*>(anorm);
  const float* tp = static_cast<const float*>(threshold);
  float* op = static_cast<float*>(out);
  if (threshold)
    wanda_partials_kernel<T, true><<<grid, kThreads, 0, st>>>(
        wp, ap, tp, op, K, N, ld, vec);
  else
    wanda_partials_kernel<T, false><<<grid, kThreads, 0, st>>>(
        wp, ap, tp, op, K, N, ld, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out: (ceil(K / 64), ceil(N / 256)) f32, row-major. w: (K, N) with unit
// stride over N and row stride ld; anorm: (K,) f32; threshold: null
// (per-tile sums of |w| * anorm) or one f32 on the device (per-tile
// counts of |w| * anorm > threshold). Launches on `stream` and returns
// the CUDA error of the launch (0 on success). The caller checks
// ceil(K / 64) <= 65535.
int wanda_partials_f32(const void* w, const void* anorm,
                       const void* threshold, void* out, int K, int N,
                       long long ld, void* stream) {
  return launch<float>(w, anorm, threshold, out, K, N, ld, stream);
}

int wanda_partials_bf16(const void* w, const void* anorm,
                        const void* threshold, void* out, int K, int N,
                        long long ld, void* stream) {
  return launch<__nv_bfloat16>(w, anorm, threshold, out, K, N, ld, stream);
}

}  // extern "C"
