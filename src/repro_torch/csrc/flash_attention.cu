// Causal GQA flash attention for Hopper (sm_90a), the long-prefill path.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _kernel): causal GQA self-attention with an online
// softmax (m, l, acc) carried over KV blocks, strictly future blocks
// skipped and only the diagonal block masked, out = acc / max(l, 1e-30).
// There the grid's last axis walks the KV blocks in order with (m, l,
// acc) in VMEM scratch. Here one thread block owns one (batch * q head,
// query tile) and walks the KV tiles 0..diagonal itself, the longest
// tiles first. The KV head of q head h is h / group, any group.
//
// Layouts, all contiguous, in the model's own order so the wrapper makes
// no copies: q, out (B, S, n_q, D); k, v (B, S, n_kv, D). S is a
// multiple of 64; D is one of 16, 32, 64, 128, 192, 256.
//
// Bound on the H100: operations. Causal attention at S 3072, 24 q heads,
// D 128 does 4 * D * n_q * S * (S + 1) / 2 FLOPs against ~30 MB of
// q/k/v/out: over 100x more time at either peak (989 TFLOP/s bf16 on
// the tensor cores, 67 TFLOP/s f32 FFMA) than at the memory rate.
//
// Two routines:
//
// f32 (flash_attention_kernel<float, D>): IEEE FFMA, no TF32, which the
// f32 gates need. 64-row Q tiles and 64-row K/V tiles staged in shared
// memory; 256 threads, thread (ty, tx) scores rows 4*ty..4*ty+3 against
// columns tx + 16*c, reduces row max and row sum with warp shuffles,
// writes its probabilities to shared memory and accumulates rows 4*ty..
// over output columns tx + 16*j in registers, with expf. The f32 tiles
// take 4 * 64 * (3 D + 65 + 1) bytes: 213.5 KB at D 256. Its limit is
// the FFMA rate and a shared-memory load on every FMA pair.
//
// bf16 (fb::flash_bf16_kernel<D>): the tensor cores by wgmma. Q tiles
// of 128 rows (two warpgroups of 64, 16 rows a warp), loaded once; K and
// V tiles of 64 rows stream through a ring of 16-byte cp.async copies,
// the next one or two in flight (as shared memory allows) while one is
// multiplied, one __syncthreads a tile. Shared tiles are 64-column slabs
// of 128-byte rows with the 128-byte XOR swizzle, which the wgmma
// descriptors name as they are. Each warpgroup runs S = Q K^T (Q and K by
// descriptor, K-major), the online softmax on the f32 score fragments in
// registers (scale and log2(e) folded into one exp2 argument on the SFU,
// row max by quad shuffles, the row sum kept per thread and reduced once
// at the end, only tiles across the diagonal masked), then O += P V with
// P from registers (the score fragment converted to bf16 is the next
// product's A fragment, so P never touches shared memory) and V an
// N-major B operand. acc stays in f32 registers and is written as bf16
// after acc * (1 / max(l, 1e-30)). P is rounded to bf16 before P.V as
// the plain version does; the TPU kernel keeps it in f32, and the two
// differ by under a bf16 ulp of the output. At D <= 128 a thread keeps
// to 128 registers, and a block to half an SM's shared memory (a ring
// of two tiles), so that two blocks share an SM: one block's softmax
// runs while the other's products hold the tensor cores. At D 192 and
// 256 the accumulator alone is 96 and 128 registers, and one block an
// SM is what fits.
//
// Each warp's own mma.sync.m16n8k16 products on ldmatrix fragments, and
// 64-row Q tiles, were measured on the same layout and were slower at
// every head shape timed. K and V arrive by cp.async rather than TMA:
// every thread issues a fixed share of a tile's copies, which needs no
// tensor-map descriptors on the host and no producer warp. cp.async
// reads 16 bytes at a time, so q, k and v must start on 16 bytes.
#include <cmath>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // query rows and kv rows per tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

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


// ---------------------------------------------------------------- bf16
//
// One thread block owns one (batch * q head, 128-row query tile) and
// walks the KV tiles of 64 rows from 0 to the diagonal. Q, K and V sit in
// shared memory as bf16 in slabs of 64 columns whose rows are 128 bytes,
// the 16-byte chunk c of row r stored at chunk c ^ (r % 8).
namespace fb {

constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int slabs(int d) { return (d + 63) / 64; }

constexpr int kBM = 128;                // query rows per tile
constexpr int kBN = 64;                 // kv rows per tile
constexpr int kThr = 2 * kBM;           // two warpgroups, 16 rows a warp

// blocks an SM holds: two at D <= 128 (at most 128 registers a thread),
// else one
__host__ __device__ constexpr int blocks_per_sm(int d) {
  return d <= 128 ? 2 : 1;
}

template <int D>
struct Layout {
  static constexpr int kQ = slabs(D) * kBM * 128;
  static constexpr int kKV = slabs(D) * kBN * 128;     // one K or V tile
  static constexpr int kStage = 2 * kKV;
  // three stages where they fit in a block's share of the SM's 228 KB
  // (1 KB of each block's share is reserved), else two
  static constexpr int kS =
      kQ + 3 * kStage + 1024 <= 233472 / blocks_per_sm(D) - 1024 ? 3 : 2;
  static constexpr int kBytes = kQ + kS * kStage + 1024;  // + alignment
};

// byte offset of 16-byte chunk ch of row r in a tile of `rows` rows
__device__ __forceinline__ unsigned swz(int r, int ch, int rows) {
  return (ch >> 3) * rows * 128 + r * 128 + (((ch & 7) ^ (r & 7)) << 4);
}

// 2^x by the SFU (relative error ~2^-22, subnormals flushed): P is
// rounded to bf16 after it
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&p);
}

// ---- wgmma: a warpgroup's 64 x 64 x 16 products
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// shared memory written by this thread (cp.async, st.shared) becomes
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving a register's reads or writes across the
// asynchronous wgmma that reads or writes it (CUTLASS's
// warpgroup_fence_operand)
template <int N, int M>
__device__ __forceinline__ void fence_regs(float (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+f"(r[i][j])::"memory");
}
template <int N, int M>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}
// 128-byte swizzle, start address, leading and stride byte offsets
__device__ __forceinline__ uint64_t desc128(unsigned addr, unsigned lbo,
                                            unsigned sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

#define FB_D32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define FB_R32                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
  "%28, %29, %30, %31}"

// d (32 floats) (+)= A (64 x 16, shared, K-major) B (16 x 64, shared,
// K-major); `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FB_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : FB_D32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}
// d (32 floats) += A (64 x 16, registers) B (16 x 64, shared, N-major)
__device__ __forceinline__ void wgmma_rs(float* d, const unsigned (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " FB_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : FB_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef FB_D32
#undef FB_R32

template <int D>
__global__ void __launch_bounds__(kThr, blocks_per_sm(D))
flash_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ out, int S, int n_q, int n_kv,
                  float scale) {
  using namespace mma_sm90;
  using L = Layout<D>;
  constexpr int kS = L::kS;
  constexpr int CH = D / 8;             // 16-byte chunks of a row
  constexpr int KK = (D + 15) / 16;     // k16 steps of Q.K
  constexpr int NT = slabs(D) * 8;      // output n8 tiles: whole slabs
  extern __shared__ unsigned char smem_raw[];
  const unsigned base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const unsigned sq = base, skv = base + L::kQ;

  const int bh = blockIdx.x;
  const int b = bh / n_q, h = bh % n_q;
  const int hk = h / (n_q / n_kv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const int rows = min(kBM, S - q0);                   // 64 or 128
  const int n_tiles = (q0 + rows - 1) / kBN + 1;
  const int tid = threadIdx.x, lane = tid & 31, wi = tid >> 5;
  const size_t q_row = static_cast<size_t>(n_q) * D;
  const size_t kv_row = static_cast<size_t>(n_kv) * D;
  const __nv_bfloat16* qb =
      q + (static_cast<size_t>(b) * S + q0) * q_row + h * D;
  const size_t kv0 = static_cast<size_t>(b) * S * kv_row + hk * D;
  const __nv_bfloat16* kb = k + kv0;
  const __nv_bfloat16* vb = v + kv0;

  for (int i = tid; i < kBM * CH; i += kThr) {
    const int r = i / CH, ch = i % CH;
    cp_async16(sq + swz(r, ch, kBM), qb + (r < rows ? r : 0) * q_row + ch * 8,
               r < rows);
  }
  // Each thread's share of a K/V tile's 16-byte copies is fixed but for
  // the tile where CH divides the thread count: chunk tid % CH of rows
  // tid / CH + kRP n (D 192's 24 chunks a row take the plain loop)
  constexpr bool kFixed = kThr % CH == 0;
  constexpr int kRP = kFixed ? kThr / CH : 1;     // rows a pass
  const int cr = tid / CH, cc = tid % CH;
  const size_t csrc = cr * kv_row + cc * 8;
  auto issue = [&](int t, int st) {
    const unsigned ks = skv + st * L::kStage, vs = ks + L::kKV;
    const size_t off = static_cast<size_t>(t) * kBN * kv_row;
    if constexpr (kFixed) {
#pragma unroll
      for (int n = 0; n < (kBN + kRP - 1) / kRP; ++n) {
        const int r = cr + kRP * n;
        if (kBN % kRP == 0 || r < kBN) {
          const unsigned dst = swz(r, cc, kBN);
          const size_t at = off + csrc + static_cast<size_t>(kRP * n) * kv_row;
          cp_async16(ks + dst, kb + at, true);
          cp_async16(vs + dst, vb + at, true);
        }
      }
    } else {
      for (int i = tid; i < kBN * CH; i += kThr) {
        const int r = i / CH, ch = i % CH;
        const size_t at = off + r * kv_row + ch * 8;
        cp_async16(ks + swz(r, ch, kBN), kb + at, true);
        cp_async16(vs + swz(r, ch, kBN), vb + at, true);
      }
    }
  };
  // the ring: Q rides with tile 0; tile t + kS - 1 is issued at turn t
#pragma unroll
  for (int t = 0; t < kS - 1; ++t) {
    if (t < n_tiles) issue(t, t);
    cp_async_commit();
  }

  // this warp's 16 rows: wr0 + lane / 4 and wr0 + lane / 4 + 8
  const int wr0 = q0 + 16 * wi;
  // the 64 rows whose products run together: the warp's warpgroup's
  const int g0 = q0 + 64 * (wi >> 2);
  // the last KV tile these rows see; -1 for rows past S. Broadcast from
  // lane 0 so the compiler knows it is uniform across the warp: the
  // warpgroup's wgmma sit on branches that depend on it
  const int last = __shfl_sync(
      0xffffffffu,
      g0 - q0 < rows ? min(n_tiles - 1, (g0 + 63) / kBN) : -1, 0);
  const float sl = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float s[kBN / 8][4];    // scores: rows r0, r0 + 8, columns of n8 tile j
  unsigned pa[kBN / 16][4];   // P in bf16: the A fragment of k16 step kk
  float alpha[2];
  const int r0 = wr0 + (lane >> 2);
  auto k_stage = [&](int t) { return skv + (t % kS) * L::kStage; };

  // S = Q K^T: K-major 64-column slabs, k16 step kk 32 bytes into slab
  // kk / 4. Issued and committed, not waited for.
  auto qk_wgmma = [&](unsigned ks) {
    const unsigned qa = sq + (g0 - q0) * 128;
#pragma unroll
    for (int kk = 0; kk < KK; ++kk) {
      const unsigned off = (kk & 3) * 32;
      wgmma_ss(&s[0][0], desc128(qa + (kk >> 2) * kBM * 128 + off, 16, 1024),
               desc128(ks + (kk >> 2) * kBN * 128 + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  // O += P V: V an N-major B operand, k16 step kk rows 16 kk.. of each
  // 64-column slab js. Issued and committed, not waited for.
  auto pv_wgmma = [&](unsigned vs) {
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int js = 0; js < slabs(D); ++js)
        wgmma_rs(&acc[8 * js][0], pa[kk],
                 desc128(vs + js * kBN * 128 + kk * 16 * 128, kBN * 128,
                         1024));
    wgmma_commit();
  };
  // the online softmax of the scores of the tile at column c0, in log2
  // units (p = 2^(s sl - m sl)): updates m and l, leaves P in `pa` as
  // bf16 A fragments (n8 tiles 2kk, 2kk + 1 are k16 step kk) and the
  // factor acc must take in `alpha`
  auto softmax = [&](int c0) {
    if (c0 + kBN - 1 > g0) {             // a tile that crosses the diagonal
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * (lane & 3) + (e & 1);
          if (col > r0 + (e >> 1) * 8) s[j][e] = -INFINITY;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float ms[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = ex2((m[i] - mx[i]) * sl);
      m[i] = mx[i];
      ms[i] = mx[i] * sl;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], sl, -ms[e >> 1]));
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
    }
  };
  auto rescale = [&]() {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  };

  // The ring: tile t + kS - 1 is issued at turn t, into the stage tile
  // t - 1 was read from, after the barrier that follows every warp's
  // last read of it.
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kS - 2>();           // tile t (and Q) landed: mine ...
    fence_proxy_async();
    __syncthreads();                   // ... and everyone's; the stage
    //                                    read at turn t - 1 is free
    if (t + kS - 1 < n_tiles) issue(t + kS - 1, (t + kS - 1) % kS);
    cp_async_commit();
    if (t > last) continue;            // past S, or all in the future
    fence_regs(s);
    wgmma_fence();
    qk_wgmma(k_stage(t));
    wgmma_wait();
    fence_regs(s);
    softmax(t * kBN);
    rescale();
    fence_regs(acc);
    fence_regs(pa);
    wgmma_fence();
    pv_wgmma(k_stage(t) + L::kKV);
    wgmma_wait();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  if (wr0 - q0 >= rows) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      __nv_bfloat16* o = out + (static_cast<size_t>(b) * S + r0 + 8 * i) *
                                   q_row + h * D + 8 * j +
                         2 * (lane & 3);
      *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(
          acc[j][2 * i] * l[i], acc[j][2 * i + 1] * l[i]);
    }
}

}  // namespace fb

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int n_q, int n_kv, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<D>();
  auto kern = flash_attention_kernel<T, D>;
  // the attribute once per instantiation, so a call pays no host time
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(S / kTile, B * n_q);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, n_q, n_kv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16_d(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int n_q, int n_kv, float scale,
                  cudaStream_t stream) {
  constexpr int smem = fb::Layout<D>::kBytes;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fb::flash_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * n_q, (S + fb::kBM - 1) / fb::kBM);
  fb::flash_bf16_kernel<D><<<grid, fb::kThr, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      S, n_q, n_kv, scale);
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

int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int n_q, int n_kv, int D, float scale,
                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch_bf16_d<16>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 32:
      return launch_bf16_d<32>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 64:
      return launch_bf16_d<64>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 128:
      return launch_bf16_d<128>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 192:
      return launch_bf16_d<192>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    case 256:
      return launch_bf16_d<256>(q, k, v, out, B, S, n_q, n_kv, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns the CUDA error of the
// launch (0 on success). The caller checks shapes: S % 64 == 0, S >= 64,
// n_q % n_kv == 0, B * n_q <= 65535, D in {16, 32, 64, 128, 192, 256};
// and, for bf16 (16-byte cp.async copies), that q, k and v start on 16
// bytes.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* out, int B, int S, int n_q, int n_kv, int D,
                        float scale, void* stream) {
  return launch<float>(q, k, v, out, B, S, n_q, n_kv, D, scale, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* out, int B, int S, int n_q, int n_kv, int D,
                         float scale, void* stream) {
  return launch_bf16(q, k, v, out, B, S, n_q, n_kv, D, scale, stream);
}

}  // extern "C"
