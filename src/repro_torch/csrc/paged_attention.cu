// Paged decode attention for Hopper (sm_90a): one query token per
// sequence attends over its KV cache in a shared paged arena, read in
// place through the sequence's block table.
//
// Replaces the TPU kernel src/repro/kernels/paged_attention/kernel.py
// (paged_attention / _kernel). There the grid's last axis walks a row's
// block table in order on one core, carrying (m, l, acc) in VMEM from
// step to step, and steps past the length are clamped onto block 0 so
// their copies are elided. On the H100 one thread block per (row, kv
// head) left most of the 132 SMs idle behind the longest row (the first
// design: 1.55 ms for a 3115-token row on an H100 80GB HBM3, 200x its
// byte bound), so the
// walk is split across thread blocks (flash-decoding), in two launches:
//
// 1. paged_attention_partition_kernel, grid (partition, kv head, row).
//    A partition is part_blocks whole KV blocks: the launcher's rule
//    (kernel.py::partition_blocks), 128 positions rounded down to whole
//    blocks, at least one. It depends on the block size alone, never on
//    the batch, the other rows or the card, so a row's sums run in the
//    same order alone or in any batch. One round trip reads the length,
//    the partition's table entries and the group's query rows; a
//    partition past its row's length then exits; partition 0 always
//    runs, so a length-0 row writes zeros, as the TPU kernel's
//    acc / max(l, 1e-30) does.
//    The block streams its partition's K rows, then its V rows, through
//    a ring of kStages shared-memory items (16 positions in f32, 32 in
//    bf16: 64 bytes of each of a row's D / 4 chunks) filled by 16-byte
//    cp.async copies (8-byte for bf16 rows that are not a multiple of 16
//    bytes), kStages - 1 items ahead of the item in use: the next items'
//    copies overlap this item's math, and the first V items arrive while
//    the softmax runs.
//    - Scores: warp w owns heads w, w + 4, ... of the GQA group (at
//      most 16). Its lanes hold those heads' pre-scaled query rows in
//      registers (lane l: elements 4l..4l+3, and 128+4l.. when D > 128),
//      with no branch in the loop (a lane past D holds zeros), and each
//      16 positions' dot products of a head are summed across the lanes
//      by one butterfly of 16 shuffles.
//    - Softmax over the partition: one warp a head, lanes strided over
//      the positions, max and sum by shuffles; p = exp(s - m) stays in
//      shared memory.
//    - Output: each thread owns float4 slices of the group's (head, D)
//      rows and sums p * v over the partition's positions, in order, in
//      registers.
//    f32 math in both types: bf16 is widened on load; expf and FFMA, no
//    TF32. A row that fits one partition writes acc / max(l, 1e-30)
//    directly; otherwise the partition writes (m, l, acc) in f32 to the
//    workspace the launcher allocates.
// 2. paged_attention_merge_kernel, grid (query head, row), launched only
//    when the table spans more than one partition: over the row's live
//    partitions, w_p = exp(m_p - max m), and the output is
//    sum_p w_p acc_p / max(sum_p w_p l_p, 1e-30), both sums in partition
//    order. No atomics: every sum has a fixed order, so rows that read
//    the same blocks with the same query and length give bitwise-equal
//    outputs.
//
// Layouts, all contiguous: q (B, n_q, D); k, v arenas (n_blocks + 1, bs,
// n_kv, D), 16-byte aligned; block_tables (B, max_blocks) int32 arena
// block ids; lengths (B,) int32, clamped to [0, max_blocks * bs]; out
// (B, n_q, D); workspace f32: acc (B, n_kv, n_parts, group, D), then m
// and l (B, n_kv, n_parts, group) each. The GQA group n_q / n_kv is 1 to
// 16, D a multiple of 4 up to 256, the block size any.
//
// Bound on the H100: bytes. A decode step must read each row's live K/V
// (2 * length * n_kv * D elements) once; the FLOPs (4 * length * n_q *
// D) are about one per byte at group 3, far below the FFMA ridge, so
// tensor cores are no lever. What this design still leaves on the
// table (PERF.md, section 6): a block's walk is a chain of dependent steps
// (the table and length, then the first items, 8 or 16 ring items, the
// softmax, then the merge launch), so a short partition is latency and
// not bytes, and the ring streams at about 2 TB/s on that card; one
// warp in four idles in the score and output phases at group 3 (the
// pruned llama's); a partition past a row's length still costs its block
// one read of the length; the merge is a second launch.
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                  // positions a reduction sums
// KV positions per ring item: 64 bytes of a row's D / 4 chunks either
// way (16 in f32, 32 in bf16), so a bf16 block takes half the steps
template <typename T>
constexpr int kItem = kRows * 4 / static_cast<int>(sizeof(T));
constexpr int kStages = 4;                 // ring depth
constexpr int kHeadsPerWarp = 4;
constexpr int kMaxGroup = kWarps * kHeadsPerWarp;             // 16
constexpr int kMaxD = 256;
constexpr int kAccChunks = kMaxGroup * (kMaxD / 4) / kThreads;  // 8
constexpr int kQLoads = kMaxGroup * kMaxD / kThreads;           // 32
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 227 * 1024;       // kernel.py::SMEM_LIMIT

// Dynamic shared memory of one partition block: the ring (kStages items
// of 64 bytes of each of a row's D / 4 chunks), the group's pre-scaled
// query rows (group x D floats), the scores (group rows of P + 1 floats),
// m and l (group each), the partition's arena rows (P ints).
// kernel.py::smem_bytes mirrors it.
size_t smem_bytes(int group, int D, int P) {
  return static_cast<size_t>(kStages) * 64 * D +
         sizeof(float) * (static_cast<size_t>(group) * (D + P + 1) +
                          2 * group) +
         sizeof(int) * static_cast<size_t>(P);
}

__device__ __forceinline__ int clamp_length(int length, int cap) {
  return length < 0 ? 0 : (length > cap ? cap : length);
}

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

// Four consecutive elements of shared memory as f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned*>(&lo);
  u.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void fma4(float4& a, float p, float4 x) {
  a.x = fmaf(p, x.x, a.x);
  a.y = fmaf(p, x.y, a.y);
  a.z = fmaf(p, x.z, a.z);
  a.w = fmaf(p, x.w, a.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

template <int VB>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src) {
  if constexpr (VB == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One halving step of reduce_rows: lanes keep rows [0, N) or [N, 2N) of
// v (by lane bit 2N), add the partner lane's copy of those rows, and
// hold them in v[0..N).
template <int N>
__device__ __forceinline__ void halve_rows(float (&v)[kRows], int lane) {
  const bool upper = lane & (2 * N);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = upper ? v[i] : v[i + N];
    const float keep = upper ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * N);
  }
  if constexpr (N > 1) halve_rows<N / 2>(v, lane);
}

// Sums v[r] over the warp's lanes for the kRows (16) rows at once in 16
// shuffles; on return lanes 2r and 2r + 1 hold row r's sum. The tree is
// fixed, so each sum's order is too.
__device__ __forceinline__ float reduce_rows(float (&v)[kRows], int lane) {
  halve_rows<kRows / 2>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// NCH: float4 chunks of D a lane holds in the score phase, 1 for D <= 128
// and 2 up to 256; VB: bytes a cp.async copies.
template <typename T, int VB, int NCH>
__global__ void __launch_bounds__(kThreads)
paged_attention_partition_kernel(const T* __restrict__ q,
                                 const T* __restrict__ k,
                                 const T* __restrict__ v,
                                 const int* __restrict__ tables,
                                 const int* __restrict__ lengths,
                                 T* __restrict__ out, float* __restrict__ ws,
                                 int n_q, int n_kv, int D, int bs,
                                 int max_blocks, int part_blocks,
                                 float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int p = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_parts = gridDim.x;
  const int group = n_q / n_kv;
  const int P = part_blocks * bs;          // positions per partition
  const int nc = D / 4;                    // float4 chunks of a row
  const int sstride = P + 1;
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + static_cast<size_t>(kStages) *
                                                  64 * D);
  float* sc = qs + group * D;
  float* ms = sc + group * sstride;
  float* ls = ms + group;
  int* arow = reinterpret_cast<int*>(ls + group);  // arena row a position

  // one round trip: the length, the partition's table entries (at most
  // kThreads: part_blocks <= 128) and the group's query rows
  const int length_in = lengths[b];
  const int* table = tables + static_cast<size_t>(b) * max_blocks +
                     static_cast<size_t>(p) * part_blocks;
  const int n_entries = min(part_blocks, max_blocks - p * part_blocks);
  const int entry = tid < n_entries ? table[tid] : 0;
  const T* qb = q + (static_cast<size_t>(b) * n_q + h * group) * D;
  float qv[kQLoads];
#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int x = tid + kThreads * j;
    qv[j] = x < group * D ? to_f32(qb[x]) : 0.f;
  }
  if (tid < n_entries) arow[tid * bs] = entry * bs;
#pragma unroll
  for (int j = 0; j < kQLoads; ++j) {
    const int x = tid + kThreads * j;
    if (x < group * D) qs[x] = qv[j] * scale;
  }
  const int length = clamp_length(length_in, max_blocks * bs);
  const int row_parts = (length + P - 1) / P;
  if (p > 0 && p >= row_parts) return;     // past the row's length

  const int n_valid = max(0, min(P, length - p * P));
  const int n_items = (n_valid + kItem<T> - 1) / kItem<T>;
  __syncthreads();
  for (int t = tid; t < n_valid; t += kThreads)
    if (t % bs) arow[t] = arow[t - t % bs] + t % bs;

  // the warp's heads' query rows, pre-scaled, in registers; a lane past
  // the row (D < 32 NCH * 4) holds zeros and reads a clamped chunk, so the
  // score loop has no branch
  float4 qr[kHeadsPerWarp][NCH];
  int kc[NCH];                             // the lane's chunk offsets
#pragma unroll
  for (int c = 0; c < NCH; ++c) kc[c] = 4 * min(lane + 32 * c, nc - 1);
#pragma unroll
  for (int j = 0; j < kHeadsPerWarp; ++j) {
    const int g = warp + kWarps * j;
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      qr[j][c] = g < group && lane + 32 * c < nc
                     ? load4(qs + g * D + 4 * (lane + 32 * c))
                     : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // this thread's share of an item's copies: (row, chunk) from tid, then
  // steps of kThreads chunks
  const int cpr = D * static_cast<int>(sizeof(T)) / VB;   // copies a row
  const int r_first = tid / cpr, c_first = tid % cpr;
  const int r_step = kThreads / cpr, c_step = kThreads % cpr;
  const size_t row_stride = static_cast<size_t>(n_kv) * D;
  const unsigned ring_addr =
      static_cast<unsigned>(__cvta_generic_to_shared(ring));
  const int stage_elems = kItem<T> * D;
  const int row_bytes = D * static_cast<int>(sizeof(T));
  __syncthreads();                         // arow is written

  // item i < n_items: K rows kItem * i ..; then the V rows, the same way
  auto issue = [&](int i) {
    if (i < 2 * n_items) {
      const bool is_v = i >= n_items;
      const int r0 = (is_v ? i - n_items : i) * kItem<T>;
      const int rows = min(kItem<T>, n_valid - r0);
      const char* src =
          reinterpret_cast<const char*>((is_v ? v : k) + h * D);
      const unsigned dst = ring_addr + (i % kStages) * stage_elems *
                                           static_cast<int>(sizeof(T));
      int r = r_first, c = c_first;
      while (r < rows) {
        cp_async<VB>(dst + r * row_bytes + c * VB,
                     src + (static_cast<size_t>(arow[r0 + r]) * row_stride) *
                               sizeof(T) + c * VB);
        r += r_step;
        c += c_step;
        if (c >= cpr) {
          c -= cpr;
          ++r;
        }
      }
    }
    cp_async_commit();                     // empty groups keep the count
  };

#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // scores of the K items
  int i = 0;
  for (; i < n_items; ++i) {
    cp_async_wait<kStages - 2>();          // item i's copies have landed
    __syncthreads();                       // ... all of them; stage i - 1
    issue(i + kStages - 1);                // is free to refill
    const T* stage = ring + (i % kStages) * stage_elems;
    const int r0 = i * kItem<T>;
    const int rows = min(kItem<T>, n_valid - r0);
#pragma unroll
    for (int j = 0; j < kHeadsPerWarp; ++j) {
      const int g = warp + kWarps * j;
      if (g >= group) break;
#pragma unroll
      for (int u = 0; u < kItem<T>; u += kRows) {  // 16 rows a reduction
        if (u >= rows) break;
        float s[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float a = 0.f;
#pragma unroll
          for (int c = 0; c < NCH; ++c)
            a = dot4(qr[j][c], load4(stage + (u + r) * D + kc[c]), a);
          s[r] = a;
        }
        const float tot = reduce_rows(s, lane);
        if (lane % 2 == 0 && u + lane / 2 < rows)
          sc[g * sstride + r0 + u + lane / 2] = tot;
      }
    }
  }
  __syncthreads();                         // every score is written

  // softmax over the partition: one warp a head
  for (int g = warp; g < group; g += kWarps) {
    float* s = sc + g * sstride;
    float m = kNegInf;
    for (int t = lane; t < n_valid; t += 32) m = fmaxf(m, s[t]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float l = 0.f;
    for (int t = lane; t < n_valid; t += 32) {
      const float e = expf(s[t] - m);
      s[t] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      l += __shfl_xor_sync(0xffffffffu, l, off);
    if (lane == 0) {
      ms[g] = m;
      ls[g] = l;
    }
  }

  // p @ V over the V items: thread owns chunks tid + kThreads * j of the
  // group's (head, D / 4) grid
  const int n_acc = group * nc;
  float4 acc[kAccChunks];
  int p_off[kAccChunks], v_off[kAccChunks];
#pragma unroll
  for (int j = 0; j < kAccChunks; ++j) {
    const int c = tid + kThreads * j;
    const int g = c / nc;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    p_off[j] = g * sstride;
    v_off[j] = 4 * (c - g * nc);
  }
  for (; i < 2 * n_items; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                       // also: the softmax is done
    issue(i + kStages - 1);
    const T* stage = ring + (i % kStages) * stage_elems;
    const int r0 = (i - n_items) * kItem<T>;
    const int rows = min(kItem<T>, n_valid - r0);
#pragma unroll
    for (int j = 0; j < kAccChunks; ++j) {
      if (tid + kThreads * j >= n_acc) break;
      const float* pr = sc + p_off[j] + r0;
      const T* vr = stage + v_off[j];
      float4 a = acc[j];
      if (rows == kItem<T>) {              // a whole item, unrolled
#pragma unroll
        for (int r = 0; r < kItem<T>; ++r) fma4(a, pr[r], load4(vr + r * D));
      } else {
        for (int r = 0; r < rows; ++r) fma4(a, pr[r], load4(vr + r * D));
      }
      acc[j] = a;
    }
  }
  cp_async_wait<0>();
  __syncthreads();                         // ms, ls are written

  if (row_parts <= 1) {                    // the whole row: write it
    T* ob = out + (static_cast<size_t>(b) * n_q + h * group) * D;
#pragma unroll
    for (int j = 0; j < kAccChunks; ++j) {
      const int c = tid + kThreads * j;
      if (c >= n_acc) break;
      const int g = c / nc;
      const float den = fmaxf(ls[g], 1e-30f);
      const float4 a = acc[j];
      store4(ob + g * D + v_off[j],
             make_float4(a.x / den, a.y / den, a.z / den, a.w / den));
    }
    return;
  }
  const size_t slot =
      (static_cast<size_t>(b) * n_kv + h) * n_parts + p;  // (b, h, p)
  const size_t n_slots = static_cast<size_t>(gridDim.z) * n_kv * n_parts;
  float* wacc = ws + slot * group * D;
#pragma unroll
  for (int j = 0; j < kAccChunks; ++j) {
    const int c = tid + kThreads * j;
    if (c >= n_acc) break;
    store4(wacc + c / nc * D + v_off[j], acc[j]);
  }
  if (tid < group) {
    float* wm = ws + n_slots * group * D;
    wm[slot * group + tid] = ms[tid];
    wm[(n_slots + slot) * group + tid] = ls[tid];
  }
}

// Dynamic shared memory of the merge: the weight and the l of each of
// the n_parts partitions, and the denominator. kernel.py::merge_smem_bytes
// mirrors it.
size_t merge_smem_bytes(int n_parts) {
  return sizeof(float) * (2 * static_cast<size_t>(n_parts) + 1);
}

// One thread block per (query head, row): the weights of the row's live
// partitions, then each output element's sum over them in partition
// order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_attention_merge_kernel(const int* __restrict__ lengths,
                             const float* __restrict__ ws,
                             T* __restrict__ out, int n_q, int n_kv, int D,
                             int bs, int max_blocks, int part_blocks,
                             int n_parts) {
  extern __shared__ float msm[];
  const int hq = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int group = n_q / n_kv, h = hq / group, g = hq % group;
  const int P = part_blocks * bs;
  const int length = clamp_length(lengths[b], max_blocks * bs);
  const int row_parts = (length + P - 1) / P;
  if (row_parts <= 1) return;              // the partition kernel wrote it
  const size_t slot = (static_cast<size_t>(b) * n_kv + h) * n_parts;
  const size_t n_slots = static_cast<size_t>(gridDim.y) * n_kv * n_parts;
  const float* acc = ws + (slot * group + g) * D;    // partition stride
  const float* m = ws + n_slots * group * D + slot * group + g;
  const float* l = m + n_slots * group;
  float* wt = msm;                         // m, then exp(m - max m)
  float* ls = msm + n_parts;
  for (int pp = tid; pp < row_parts; pp += kThreads) {
    wt[pp] = m[static_cast<size_t>(pp) * group];
    ls[pp] = l[static_cast<size_t>(pp) * group];
  }
  __syncthreads();
  if (tid < 32) {                          // warp 0: max, weights, then
    float mx = kNegInf;                    // the denominator in order
    for (int pp = tid; pp < row_parts; pp += 32) mx = fmaxf(mx, wt[pp]);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    for (int pp = tid; pp < row_parts; pp += 32) wt[pp] = expf(wt[pp] - mx);
    __syncwarp();
    if (tid == 0) {
      float d = 0.f;
      for (int pp = 0; pp < row_parts; ++pp) d = fmaf(ls[pp], wt[pp], d);
      msm[2 * n_parts] = fmaxf(d, 1e-30f);
    }
  }
  __syncthreads();
  const float den = msm[2 * n_parts];
  T* ob = out + (static_cast<size_t>(b) * n_q + hq) * D;
  const size_t stride = static_cast<size_t>(group) * D;
  for (int e = tid; e < D; e += kThreads) {
    float num = 0.f;
#pragma unroll 16
    for (int pp = 0; pp < row_parts; ++pp)
      num = fmaf(acc[pp * stride + e], wt[pp], num);
    ob[e] = from_f32<T>(num / den);
  }
}

template <typename T, int VB, int NCH>
int launch_vb(const void* q, const void* k, const void* v,
              const void* tables, const void* lengths, void* out, void* ws,
              int B, int n_q, int n_kv, int D, int bs, int max_blocks,
              int part_blocks, float scale, cudaStream_t stream) {
  const int group = n_q / n_kv;
  const int n_parts = (max_blocks + part_blocks - 1) / part_blocks;
  const size_t smem = smem_bytes(group, D, part_blocks * bs);
  auto kern = paged_attention_partition_kernel<T, VB, NCH>;
  auto merge = paged_attention_merge_kernel<T>;
  // the attribute once per instantiation, at the most either kernel may
  // take (the launcher's check keeps every launch within it), so a call
  // pays no host time for it
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        paged_attention_partition_kernel<T, VB, NCH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(paged_attention_merge_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  kern<<<dim3(n_parts, n_kv, B), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<T*>(out),
      static_cast<float*>(ws), n_q, n_kv, D, bs, max_blocks, part_blocks,
      scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_parts == 1) return static_cast<int>(err);
  const size_t merge_smem = merge_smem_bytes(n_parts);
  merge<<<dim3(n_q, B), kThreads, merge_smem, stream>>>(
      static_cast<const int*>(lengths), static_cast<const float*>(ws),
      static_cast<T*>(out), n_q, n_kv, D, bs, max_blocks, part_blocks,
      n_parts);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VB>
int launch_d(const void* q, const void* k, const void* v, const void* tables,
             const void* lengths, void* out, void* ws, int B, int n_q,
             int n_kv, int D, int bs, int max_blocks, int part_blocks,
             float scale, cudaStream_t s) {
  if (D <= 128)
    return launch_vb<T, VB, 1>(q, k, v, tables, lengths, out, ws, B, n_q,
                               n_kv, D, bs, max_blocks, part_blocks, scale, s);
  return launch_vb<T, VB, 2>(q, k, v, tables, lengths, out, ws, B, n_q, n_kv,
                             D, bs, max_blocks, part_blocks, scale, s);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* lengths, void* out, void* ws, int B, int n_q,
           int n_kv, int D, int bs, int max_blocks, int part_blocks,
           float scale, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if ((D * sizeof(T)) % 16 == 0)
    return launch_d<T, 16>(q, k, v, tables, lengths, out, ws, B, n_q, n_kv,
                           D, bs, max_blocks, part_blocks, scale, s);
  if constexpr (sizeof(T) == 2)            // bf16 rows of 8k + 8 bytes
    return launch_d<T, 8>(q, k, v, tables, lengths, out, ws, B, n_q, n_kv,
                          D, bs, max_blocks, part_blocks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` (the partition kernel, then the
// merge when max_blocks spans more than one partition) and returns the
// CUDA error of the launches (0 on success). The caller checks shapes:
// n_q % n_kv == 0 with a group of at most 16, D % 4 == 0 and D <= 256,
// 16-byte aligned arenas, 1 <= B <= 65535, n_kv <= 65535, that the
// shared memory the launch asks for fits the card, and that `ws` holds
// B * n_kv * n_parts * group * (D + 2) floats whenever n_parts > 1.
int paged_attention_f32(const void* q, const void* k, const void* v,
                        const void* tables, const void* lengths, void* out,
                        void* ws, int B, int n_q, int n_kv, int D, int bs,
                        int max_blocks, int part_blocks, float scale,
                        void* stream) {
  return launch<float>(q, k, v, tables, lengths, out, ws, B, n_q, n_kv, D,
                       bs, max_blocks, part_blocks, scale, stream);
}

int paged_attention_bf16(const void* q, const void* k, const void* v,
                         const void* tables, const void* lengths, void* out,
                         void* ws, int B, int n_q, int n_kv, int D, int bs,
                         int max_blocks, int part_blocks, float scale,
                         void* stream) {
  return launch<__nv_bfloat16>(q, k, v, tables, lengths, out, ws, B, n_q,
                               n_kv, D, bs, max_blocks, part_blocks, scale,
                               stream);
}

}  // extern "C"
