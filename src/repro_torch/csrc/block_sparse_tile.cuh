// The per-tile routine of the block-sparse matmuls (block_sparse.cu and
// grouped_block_sparse.cu): one thread block computes one (kRows x BN)
// output tile y[r, c] = sum_k x[r, k] * w[k, c] over the live K-blocks of
// one N-block column, in plan order.
//
// Every kernel that includes this header maps threads to outputs the same
// way and sums in the same order: thread tid owns column c = tid % BN and
// rows rg, rg + RG, ... (rg = tid / BN, RG = kThreads / BN); each output is
// one chain of fmaf over the live K-blocks in plan order, k ascending
// within a block, with f32 inputs as they are (no TF32) and bf16 inputs
// widened to f32 on load. An output row therefore depends only on its own
// x row, the weight and the plan: the same token row comes out bitwise
// equal from kernel 1, the grouped kernel and the ragged kernel, whatever
// M-tile or row position it lands in.
//
// The weight comes from one of two sources, a template policy of the
// routine: DenseWeight reads w[k, c] of the dense (K, N) weight `w`
// (kernels 1, 6 and 7), Int8Tiles reads the step's int8 kept tile and
// multiplies it by the tile's pow2 scale on load (kernels 5, 8 and 9;
// `w` is unused). float(q) * 2^e is exact, so the staged weight tile,
// and with it every fmaf of the chain, is bitwise what the dense source
// gives over the dequantised weight; the TPU kernels scale the
// accumulated tile product instead, which would change the order of the
// sum here. The dense policy is an empty marker and `w` stays a
// __restrict__ parameter of the routine, so kernels 1, 6 and 7 compile
// to the code they had before the int8 policy existed (a pointer moved
// into a struct member loses its read-only loads and costs registers).
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace block_sparse_tile {

constexpr int kThreads = 256;
constexpr int kRows = 16;  // output rows per thread block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// The dense weight `w` (K, N): the staged element of a step is
// w[kbase + kk, col0 + cc], kernel 1's own index arithmetic.
struct DenseWeight {
  static constexpr bool kDense = true;
};

// int8 kept tiles (T, BN, BN) of a plan: step s of the column reads the
// storage row slots[s] and multiplies by scales[s]. slots / scales point
// at the column's plan row; every slot is below T (checked at pack time).
template <int BN>
struct Int8Tiles {
  static constexpr bool kDense = false;
  const int8_t* tiles;
  const int* slots;
  const float* scales;
  const int8_t* cur = nullptr;   // the step's tile and scale
  float scale = 0.f;

  __device__ __forceinline__ void step(int s) {
    cur = tiles + static_cast<size_t>(slots[s]) * (BN * BN);
    scale = scales[s];
  }
  // row k (0 .. BN-1) and column c of the step's tile, dequantised
  __device__ __forceinline__ float at(int k, int c) const {
    return static_cast<float>(cur[k * BN + c]) * scale;
  }
};

// One output tile: rows m0 .. m0 + kRows - 1 (those below M) of columns
// col0 .. col0 + BN - 1. x: (M, K) and y: (M, N) of one matrix (one
// expert's panel, or the whole packed buffer); w: its (K, N) weight,
// read when the policy q is DenseWeight; q: Int8Tiles for the int8
// storage; idx: the column's plan row, `count` live K-block ids. Rows
// at or past M read as zeros and are not written. The index arithmetic
// is kernel 1's own (int sizes, 64-bit offsets), which keeps its
// register count and its read-only loads. Every thread of the block
// must call it (it synchronises).
template <typename T, int BN, typename Q = DenseWeight>
__device__ __forceinline__ void tile(const T* __restrict__ x,
                                     const T* __restrict__ w, Q q,
                                     const int* __restrict__ idx, int count,
                                     T* __restrict__ y, int m0, int M, int K,
                                     int N, size_t col0) {
  static_assert(kThreads % BN == 0, "a row group spans the N-block");
  constexpr int KC = BN < 32 ? BN : 32;  // K rows staged per chunk
  constexpr int RG = kThreads / BN;      // row groups
  constexpr int RPT = kRows / RG;        // output rows per thread
  static_assert(RPT >= 1 && kRows % RG == 0, "rows split over groups");

  __shared__ float xs[kRows][KC];
  __shared__ float ws[KC][BN];

  const int tid = threadIdx.x;
  const int c = tid % BN;
  const int rg = tid / BN;

  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  for (int s = 0; s < count; ++s) {
    const int kb = idx[s];
    if constexpr (!Q::kDense) q.step(s);
    for (int k0 = 0; k0 < BN; k0 += KC) {
      const size_t kbase = static_cast<size_t>(kb) * BN + k0;
      for (int i = tid; i < kRows * KC; i += kThreads) {
        const int r = i / KC, kk = i % KC;
        const int row = m0 + r;
        xs[r][kk] = row < M
            ? to_f32(x[static_cast<size_t>(row) * K + kbase + kk]) : 0.f;
      }
      for (int i = tid; i < KC * BN; i += kThreads) {
        const int kk = i / BN, cc = i % BN;
        if constexpr (Q::kDense)
          ws[kk][cc] = to_f32(w[(kbase + kk) * N + col0 + cc]);
        else
          ws[kk][cc] = q.at(k0 + kk, cc);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        const float b = ws[kk][c];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          acc[i] = fmaf(xs[rg + i * RG][kk], b, acc[i]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = m0 + rg + i * RG;
    if (row < M)
      y[static_cast<size_t>(row) * N + col0 + c] = from_f32<T>(acc[i]);
  }
}

// A dead tile: zeros in rows m0 .. m0 + kRows - 1 (those below M) of
// columns col0 .. col0 + BN - 1 of y (M, N).
template <typename T, int BN>
__device__ __forceinline__ void zero_tile(T* __restrict__ y, int m0, int M,
                                          int N, size_t col0) {
  for (int i = threadIdx.x; i < kRows * BN; i += kThreads) {
    const int row = m0 + i / BN;
    if (row < M)
      y[static_cast<size_t>(row) * N + col0 + i % BN] = from_f32<T>(0.f);
  }
}

}  // namespace block_sparse_tile
