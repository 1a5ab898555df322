// The paged attention step's prologue for Hopper (sm_90a): RoPE of the
// step's q and k rows, q rotated in place, and the step's K and V rows
// written into the paged arenas, in one launch.
//
// Replaces no TPU kernel. The JAX package leaves RoPE and the arena
// scatter (src/repro/models/layers.py: rope_embed, paged_write) to XLA,
// which fuses them into the step's one program. Run eagerly, the port
// spent 54 launching ATen ops and 20 views an attention layer on them
// (RoPE of q and of k, two paged_write scatters, the index glue): at
// phi3's 64 decode rows (30 q / 10 kv heads, D 128, bf16) 739 us of host
// time a layer on an H100 80GB HBM3's host for 98 us of device work, so
// a decode tick of the phi3 cells was bound by the host issuing it. The
// tables that do not depend on the layer (cos and sin of the step's
// positions, the arena row of each position) are built once a forward
// (models/layers.py::paged_step), and this kernel is the one launch a
// layer that is left: 32 us of host time a call there.
//
// What bounds it: the host's one launch. On the device it reads and
// writes each element of q, k and v once and reads the tables once:
// 1.7 MB at those 64 decode rows, 0.50 us at 3.35 TB/s (2.7 us
// measured); 13 MB for a 512-token chunk, 4.0 us (13.5 us measured).
//
// Design: grid (token, head), the heads q's rotated heads first, then
// the kv heads; D / 2 threads a block, thread j owning the pair (j,
// j + D / 2) of its head row, so no thread reads what another writes
// and q is rotated in place. A kv block rotates its k pair and copies
// its v pair into the arena row `rows[token]`. Each element is read and
// written as a single element, so no alignment beyond the element's is
// needed, and any even D up to 2048 works.
//
// Rounding: bitwise the eager ops' (models/layers.py::_rope, then
// paged_write's copy into the arena). Each product of the input,
// widened to f32, and the f32 table is rounded (__fmul_rn), their
// difference and sum are rounded (__fsub_rn, __fadd_rn), with no FMA
// contraction, and the result is rounded once to the input's type
// (__float2bfloat16_rn for bf16); k is then converted to the arena's
// type as `.to(arena.dtype)` converts it, and v likewise.
//
// Layouts, all contiguous: q (T, n_q, D) and k, v (T, n_kv, D), T the
// step's B * S tokens; arenas (n_rows, n_kv, D) viewed as (n_blocks + 1,
// bs, n_kv, D); cos, sin (T, D / 2) f32; rows (T,) int64 arena rows. A
// row outside [0, n_rows) traps the kernel, as the eager scatter's
// device-side bounds assert stops it: the error shows at the stream's
// next sync, and no K/V is left silently unwritten.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T narrow(float x);
template <>
__device__ __forceinline__ float narrow<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// (x1 * c - x2 * s, x1 * s + x2 * c), each product and each sum rounded
// in f32 as the eager ops round them, then rounded once to T.
template <typename T>
__device__ __forceinline__ void rotate(float x1, float x2, float c, float s,
                                       T& y1, T& y2) {
  y1 = narrow<T>(__fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s)));
  y2 = narrow<T>(__fadd_rn(__fmul_rn(x1, s), __fmul_rn(x2, c)));
}

// T: q/k/v's type; A: the arenas'. n_q is the number of q heads to
// rotate: q's head count with RoPE, 0 without (cos_t is then null).
template <typename T, typename A>
__global__ void rope_kv_write_kernel(
    T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    A* __restrict__ k_arena, A* __restrict__ v_arena,
    const float* __restrict__ cos_t, const float* __restrict__ sin_t,
    const int64_t* __restrict__ rows, int n_q, int n_kv, int D,
    long long n_rows) {
  const int half = D >> 1;
  const int j = threadIdx.x;
  const long long t = blockIdx.x;
  const int h = blockIdx.y;
  const bool rope = cos_t != nullptr;
  float c = 0.f, s = 0.f;
  if (rope) {
    c = cos_t[t * half + j];
    s = sin_t[t * half + j];
  }
  if (h < n_q) {
    T* x = q + (t * n_q + h) * D;
    T y1, y2;
    rotate(widen(x[j]), widen(x[j + half]), c, s, y1, y2);
    x[j] = y1;
    x[j + half] = y2;
    return;
  }
  const int g = h - n_q;
  const long long row = rows[t];
  if (row < 0 || row >= n_rows) __trap();
  const long long src = (t * n_kv + g) * D;
  const long long dst = (row * n_kv + g) * D;
  float k1 = widen(k[src + j]), k2 = widen(k[src + j + half]);
  if (rope) {
    T y1, y2;
    rotate(k1, k2, c, s, y1, y2);
    k1 = widen(y1);
    k2 = widen(y2);
  }
  k_arena[dst + j] = narrow<A>(k1);
  k_arena[dst + j + half] = narrow<A>(k2);
  v_arena[dst + j] = narrow<A>(widen(v[src + j]));
  v_arena[dst + j + half] = narrow<A>(widen(v[src + j + half]));
}

template <typename T, typename A>
int launch(void* q, const void* k, const void* v, void* k_arena,
           void* v_arena, const void* cos_t, const void* sin_t,
           const void* rows, int n_tokens, int n_q, int n_kv, int D,
           long long n_rows, void* stream) {
  if (n_tokens == 0) return 0;
  const int q_heads = cos_t != nullptr ? n_q : 0;
  const dim3 grid(n_tokens, q_heads + n_kv);
  rope_kv_write_kernel<T, A><<<grid, D / 2, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<A*>(k_arena),
      static_cast<A*>(v_arena), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), static_cast<const int64_t*>(rows),
      q_heads, n_kv, D, n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the CUDA error of
// the launch (0 on success); the name gives q/k/v's type, then the
// arenas'. cos and sin are both null (no RoPE: the write alone) or both
// set. The caller checks shapes: D even with D / 2 <= 1024 threads,
// n_q + n_kv <= 65535, n_tokens < 2^31, every tensor contiguous.
#define ROPE_KV_WRITE_ENTRY(NAME, T, A)                                      \
  int NAME(void* q, const void* k, const void* v, void* k_arena,           \
           void* v_arena, const void* cos_t, const void* sin_t,             \
           const void* rows, int n_tokens, int n_q, int n_kv, int D,        \
           long long n_rows, void* stream) {                                \
    return launch<T, A>(q, k, v, k_arena, v_arena, cos_t, sin_t, rows,      \
                        n_tokens, n_q, n_kv, D, n_rows, stream);            \
  }

ROPE_KV_WRITE_ENTRY(rope_kv_write_f32_f32, float, float)
ROPE_KV_WRITE_ENTRY(rope_kv_write_f32_bf16, float, __nv_bfloat16)
ROPE_KV_WRITE_ENTRY(rope_kv_write_bf16_f32, __nv_bfloat16, float)
ROPE_KV_WRITE_ENTRY(rope_kv_write_bf16_bf16, __nv_bfloat16, __nv_bfloat16)

#undef ROPE_KV_WRITE_ENTRY

}  // extern "C"
