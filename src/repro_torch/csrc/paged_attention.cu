// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over its KV cache in a shared paged arena, read in
// place through the sequence's block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention / _kernel). There the block table and the lengths are
// scalar-prefetched, the grid's last axis walks every entry of the table
// in order, and steps past the length are clamped onto block 0 so their
// copies are elided. Here one thread block owns one (sequence, kv head)
// pair: it reads lengths[b] and block_tables[b, :] from global memory
// itself and its loop stops at the last live block, so a dead table entry
// costs nothing.
//
// Layouts, all contiguous: q (B, n_q, D); k, v arenas (n_blocks + 1, bs,
// n_kv, D); block_tables (B, max_blocks) int32 arena block ids; lengths
// (B,) int32; out (B, n_q, D). The GQA group (n_q / n_kv query heads per
// kv head) is any positive integer (3 on the pruned llama3-8b), the block
// size any of 8..64, D any multiple of 4 up to 256.
//
// Per live block the thread block stages K and V in shared memory (bf16
// widened to f32), scores the group's query heads against the block (one
// warp per (head, column) dot product), masks columns at or past the
// length, and folds the block into a running (m, l, acc) in f32 with
// expf and plain FFMA (no TF32). A length-0 row writes zeros, as the TPU
// kernel's acc / max(l, 1e-30) does. The order of every sum depends only
// on the row's own inputs, so rows that read the same blocks with the
// same query give bitwise-equal outputs.
//
// Bound on the H100: bytes. A decode step must read each row's live K/V
// (length * n_kv * D * 2 elements) once; the FLOPs (4 * length * n_q * D)
// are two orders below the FFMA peak at those bytes. What this simple
// design leaves on the table: scalar loads, no overlap of one block's
// load with the previous block's math, and one thread block per (row,
// kv head), so a batch of 8 with 8 kv heads fills 64 of the 132 SMs.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v,
                       const int* __restrict__ tables,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int n_q, int n_kv, int D, int bs, int max_blocks,
                       float scale) {
  extern __shared__ float smem[];
  const int group = n_q / n_kv;
  float* qs = smem;                    // (group, D), pre-scaled
  float* ks = qs + group * D;          // (bs, D)
  float* vs = ks + bs * D;             // (bs, D)
  float* acc = vs + bs * D;            // (group, D)
  float* ps = acc + group * D;         // (group, bs) scores, then probs
  float* ml = ps + group * bs;         // m (group), l (group), alpha (group)
  float* ms = ml;
  float* ls = ml + group;
  float* alphas = ml + 2 * group;

  const int b = blockIdx.x;
  const int h = blockIdx.y;            // kv head
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int GD = group * D;
  const size_t row_stride = static_cast<size_t>(n_kv) * D;  // arena row

  const T* qb = q + (static_cast<size_t>(b) * n_q + h * group) * D;
  for (int i = tid; i < GD; i += kThreads) {
    qs[i] = to_f32(qb[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  int length = lengths[b];
  if (length > max_blocks * bs) length = max_blocks * bs;
  const int n_live = length > 0 ? (length + bs - 1) / bs : 0;
  const int* table = tables + static_cast<size_t>(b) * max_blocks;

  for (int j = 0; j < n_live; ++j) {
    const size_t base =
        static_cast<size_t>(table[j]) * bs * row_stride + h * D;
    __syncthreads();                   // previous block's readers are done
    for (int i = tid; i < bs * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const size_t at = base + t * row_stride + d;
      ks[i] = to_f32(k[at]);
      vs[i] = to_f32(v[at]);
    }
    __syncthreads();
    // scores: one warp per (head, column), lanes stride over D
    for (int pair = warp; pair < group * bs; pair += kWarps) {
      const int g = pair / bs, t = pair % bs;
      float s = 0.f;
      for (int d = lane; d < D; d += 32)
        s = fmaf(qs[g * D + d], ks[t * D + d], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0) ps[pair] = (j * bs + t < length) ? s : kNegInf;
    }
    __syncthreads();
    // online softmax: one thread per head
    for (int g = tid; g < group; g += kThreads) {
      float* p = ps + g * bs;
      float m_cur = kNegInf;
      for (int t = 0; t < bs; ++t) m_cur = fmaxf(m_cur, p[t]);
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, m_cur);
      float sum = 0.f;
      for (int t = 0; t < bs; ++t) {
        const float e = expf(p[t] - m_new);
        p[t] = e;
        sum += e;
      }
      const float alpha = expf(m_prev - m_new);
      ls[g] = ls[g] * alpha + sum;
      ms[g] = m_new;
      alphas[g] = alpha;
    }
    __syncthreads();
    for (int i = tid; i < GD; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* p = ps + g * bs;
      float a = acc[i] * alphas[g];
      for (int t = 0; t < bs; ++t) a = fmaf(p[t], vs[t * D + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();
  T* ob = out + (static_cast<size_t>(b) * n_q + h * group) * D;
  for (int i = tid; i < GD; i += kThreads) {
    const float l = ls[i / D];
    ob[i] = from_f32<T>(acc[i] / fmaxf(l, 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lengths, void* out, int B, int n_q, int n_kv, int D,
           int bs, int max_blocks, float scale, void* stream) {
  const int group = n_q / n_kv;
  const size_t smem =
      sizeof(float) * (2 * group * D + 2 * bs * D + group * bs + 3 * group);
  auto kern = paged_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, n_kv);
  kern<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out), n_q, n_kv, D,
      bs, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the CUDA error of the
// launch (0 on success). The caller checks shapes: n_q % n_kv == 0,
// 1 <= B <= 65535, n_kv <= 65535, and that the shared memory the launch
// asks for fits the card.
int paged_attention_f32(const void* q, const void* k, const void* v,
                        const void* tables, const void* lengths, void* out,
                        int B, int n_q, int n_kv, int D, int bs,
                        int max_blocks, float scale, void* stream) {
  return launch<float>(q, k, v, tables, lengths, out, B, n_q, n_kv, D, bs,
                       max_blocks, scale, stream);
}

int paged_attention_bf16(const void* q, const void* k, const void* v,
                         const void* tables, const void* lengths, void* out,
                         int B, int n_q, int n_kv, int D, int bs,
                         int max_blocks, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, tables, lengths, out, B, n_q, n_kv,
                               D, bs, max_blocks, scale, stream);
}

}  // extern "C"
