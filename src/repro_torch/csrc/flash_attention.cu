// Causal GQA flash attention for Hopper (sm_90a), the long-prefill path.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _kernel). There the grid's last axis walks every KV
// block in order, carrying (m, l, acc) in VMEM scratch, with strictly
// future blocks skipped by @pl.when and only the diagonal block masked.
// Here one thread block owns one (batch * q head, 64-row query tile) and
// loops over the KV tiles 0..diagonal itself, so a future tile is never
// visited; only the diagonal tile is masked. The KV head of q head h is
// h / group, any group (3 on the pruned llama3-8b).
//
// Layouts, all contiguous, in the model's own order so the wrapper makes
// no copies: q, out (B, S, n_q, D); k, v (B, S, n_kv, D). S is a
// multiple of the 64-row tile (the model passes multiples of 1024); D is
// one of 16, 32, 64, 128, 192, 256. The f32 shared tiles take
// 4 * 64 * (3 D + 65 + 1) bytes: 213.5 KB at D 256, under the 227 KB a
// block may hold; each thread's accumulator is 4 x D/16 floats (64 at D
// 256).
//
// Each 64-row Q tile (pre-scaled by 1/sqrt(D)) and each 64-row K/V tile
// are staged in shared memory (bf16 widened to f32). 256 threads: thread
// (ty, tx) scores rows 4*ty..4*ty+3 against columns tx + 16*c, reduces
// row max and row sum across the 16 threads of its rows with warp
// shuffles, writes its probabilities to shared memory, and accumulates
// rows 4*ty.. over output columns tx + 16*j in registers. All in f32 with
// expf and plain FFMA (no TF32).
//
// Bound on the H100: operations. Causal attention at S 3072, 24 q heads,
// D 128 does 4 * D * n_q * S * (S + 64) / 2 FLOPs against ~30 MB of
// q/k/v/out: over 100x more time at the f32 FFMA peak than at the memory
// rate. What this simple design leaves on the table: no tensor cores
// (wgmma in bf16, or TF32 where an f32 reference allows it), scalar
// shared-memory traffic on every FMA pair, and no overlap of the next
// tile's load with the current tile's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // query rows and kv rows per tile
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

template <int D>
constexpr size_t smem_floats() {
  return kTile * D + kTile * (D + 1) + kTile * D + kTile * (kTile + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int n_q, int n_kv, float scale) {
  constexpr int KP = D + 1;            // padded K row: conflict-free reads
  constexpr int PP = kTile + 1;
  constexpr int DJ = D / 16;           // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // (64, D)
  float* ks = qs + kTile * D;          // (64, D + 1)
  float* vs = ks + kTile * KP;         // (64, D)
  float* ps = vs + kTile * D;          // (64, 65)

  const int qi = gridDim.x - 1 - blockIdx.x;   // the longest tiles first
  const int bh = blockIdx.y;
  const int b = bh / n_q, h = bh % n_q;
  const int hk = h / (n_q / n_kv);
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const size_t q_row = static_cast<size_t>(n_q) * D;
  const size_t kv_row = static_cast<size_t>(n_kv) * D;
  const size_t q0 = (static_cast<size_t>(b) * S + qi * kTile) * q_row + h * D;
  const size_t kv_base = static_cast<size_t>(b) * S * kv_row + hk * D;

  for (int i = tid; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    qs[i] = to_f32(q[q0 + r * q_row + d]) * scale;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[r][j] = 0.f;
  }

  for (int ki = 0; ki <= qi; ++ki) {
    __syncthreads();                   // previous tile's readers are done
    const size_t k0 = kv_base + static_cast<size_t>(ki) * kTile * kv_row;
    for (int i = tid; i < kTile * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const size_t at = k0 + t * kv_row + d;
      ks[t * KP + d] = to_f32(k[at]);
      vs[i] = to_f32(v[at]);
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int kk = 0; kk < D; ++kk) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty * 4 + r) * D + kk];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = ks[(tx + 16 * c) * KP + kk];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }
    if (ki == qi) {                    // the diagonal tile: mask the future
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (tx + 16 * c > ty * 4 + r) s[r][c] = kNegInf;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(s[r][c] - m_new);
        ps[(ty * 4 + r) * PP + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = l[r] * alpha + sum;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int t = 0; t < kTile; ++t) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ps[(ty * 4 + r) * PP + t];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[t * D + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[r][j] = fmaf(pv[r], vv[j], acc[r][j]);
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
    T* orow = out + q0 + (ty * 4 + r) * q_row;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f32<T>(acc[r][j] * inv);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int n_q, int n_kv, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = flash_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kTile, B * n_q);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, n_q, n_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int n_q, int n_kv, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_d<T, 16>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 32: return launch_d<T, 32>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 64: return launch_d<T, 64>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 128:
      return launch_d<T, 128>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 192:
      return launch_d<T, 192>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 256:
      return launch_d<T, 256>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the CUDA error of the
// launch (0 on success). The caller checks shapes: S % 64 == 0, S >= 64,
// n_q % n_kv == 0, B * n_q <= 65535, D in {16, 32, 64, 128, 192, 256}.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int n_q, int n_kv, int D,
                        float scale, void* stream) {
  return launch<float>(q, k, v, out, B, S, n_q, n_kv, D, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int n_q, int n_kv, int D,
                         float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, B, S, n_q, n_kv, D, scale,
                               stream);
}

}  // extern "C"
