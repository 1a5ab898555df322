// Mamba-2 SSD chunked scan for Hopper (sm_90a), the prefill path of every
// Mamba layer.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py (ssd_scan /
// _kernel). There the grid (B*H, n_chunks) walks the chunks of one
// (sequence, head) in order and carries the (N, P) f32 state in VMEM
// scratch, zeroed at chunk 0 and dropped at the end. On Hopper one block
// walking a head's chunks in order leaves most SMs idle at batch 1 (64
// heads), so the chunks run in parallel and only the small state pass is
// sequential. Per chunk of Q rows (Q = min(chunk, L); a ragged tail reads
// as da = 0 and zero rows, as the JAX model pads it), with Lc = cumsum(da)
// over the chunk:
//
//   y_intra = ((C B^T) o seg) xt,  seg[i,j] = exp(Lc_i - Lc_j), i >= j
//   y_inter = (C o exp(Lc)) h_c             (h_c: the state entering c)
//   S_c     = (B o exp(Lc_last - Lc))^T xt,  h_{c+1} = h_c exp(Lc_last) + S_c
//
// Four kernels run on the stream, one launch of kernel 10:
// 1. ssd_cb_kernel: C B^T once per (sequence, chunk), shared by all heads
//    (one group), as 64x64 tiles of its lower block triangle, into the
//    scratch `cb` (B, n_chunks, Qp, Qp), row-major.
// 2. ssd_state_kernel: per (sequence, chunk, head, slice of PS columns of
//    P), S_c into the scratch `hs` (B, n_chunks, H, P, N), the chunk's
//    decay exp(Lc_last) into `dec` (B, n_chunks, H) and its Lc into `lcs`
//    (B, n_chunks, H, Qp).
// 3. ssd_pass_kernel: per (sequence, head, 32 x 32 tile of the state),
//    h_{c+1} = h_c * dec_c + S_c from h0 (or zero), writing each h_c
//    transposed, in xt's type, into `ht` (B, n_chunks, H, N, P): the
//    output kernel's operand as it multiplies it. The final state goes
//    out in the cache's (B, H, P, N) layout.
// 4. ssd_out_kernel: per (sequence, chunk, head, 64-row tile, slice), the
//    tile's y: (C o exp(Lc)) h_c, then the masked scores times xt.
//
// Bound on the H100. f32: operations. At mamba2's 4096-token layer 0 (H
// 45, P 64, N 128, chunk 256) the function needs 9.2 GFLOP (the (i, j)
// products over i >= j only) against 101 MB: 0.138 ms at the FFMA peak.
// bf16: bytes (51 MB, 0.015 ms), the products being far below the
// tensor-core peak. What the design does about it:
// - Every product is a GEMM of register tiles over operands staged in
//   shared memory by 16-byte cp.async, K in items of 32 through a ring of
//   two or three stages: the next items are in flight while item t is
//   multiplied, with one barrier an item. An operand that is transformed
//   on its way in (the decayed xt, the scores) is transformed in shared
//   memory by the thread that copied it.
// - f32: IEEE FFMA (no TF32). A thread owns an 8 x 8 (state) or (PS/16) x
//   8 (output, C B^T: 4 x 8) tile of outputs and reads its operands as
//   float4 rows of shared tiles padded so that no read conflicts: 4
//   LDS.128 per 64 FFMA (state), 12 per 128 (output).
// - bf16: mma.sync m16n8k16 (bf16 in, f32 accumulate) on ldmatrix
//   fragments for all four products. The scores are rounded to bf16
//   before their product, as the JAX function and the plain version
//   round them. Two operands that are f32 in the plain version become
//   bf16 here: the decayed xt of the state product (xt exp(Lc_last -
//   Lc), rounded once) and the carried state h_c of the output's inter
//   term (rounded once by the pass). Each adds a relative rounding of
//   2^-9 to one factor of its products, well inside the 2^-7 limits
//   (max-abs and Frobenius) the kernel is held to. The chunk states,
//   their pass, the carried and final states and every accumulator stay
//   f32; y is rounded once.
// - The output kernel's grid runs over (chunk, head, 64-row tile) with
//   the four row tiles of one (chunk, head) side by side, heaviest (most
//   score items) first, so that h_c and xt come from device memory once
//   and from L2 for the others. A block builds each 64 x 32 score item
//   once in shared memory: below its own rows the decay is two factors
//   of at most 1, exp(Lc_i - Lc_i0) exp(Lc_i0 - Lc_j), computed once a
//   block; in its own 64 columns exp(Lc_i - Lc_j) only where i >= j
//   (above the diagonal it can overflow), and row groups wholly above the
//   diagonal skip the item. It adds the inter term first, so that
//   exp(Lc_i) scales its f32 sum in registers.
// - The pass reads eight chunks' states ahead of its chain.
// The floor of this design is its scratch: the f32 chunk states hs (23.6
// MB at that shape) written and read once, and h_c written and read once
// (11.8 MB in bf16): about 71 MB in bf16, ~0.021 ms at 3.35 TB/s, above
// the whole function's 51 MB.
//
// Layouts: xt, y (B, L, H, P) contiguous; da (B, L, H) f32 contiguous;
// Bm, Cm (B, L, N) with unit stride over N and the batch and position
// strides given (both are strided slices of the conv output, read in
// place; by 16-byte copies when their rows allow it, else element by
// element); h0, h_out (B, H, P, N) f32 contiguous. Q <= 256, N <= 128, P
// a multiple of the slice width PS (16, 32 or 64). No atomics: two
// launches on the same inputs give the same bits.
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace {

using namespace mma_sm90;

constexpr int kTile = 64;              // chunk rows a tile
constexpr int kKC = 32;                // K extent of an item of a ring
constexpr int kMaxQ = 256;             // largest chunk
constexpr int kMaxN = 128;             // largest state width
constexpr int kOutThreads = 128;       // output and C B^T blocks
constexpr float kLog2e = 1.4426950408889634f;

template <typename T>
constexpr bool kIsBf16 = std::is_same<T, __nv_bfloat16>::value;
// Elements in 16 bytes; shared rows are padded by 16 bytes, so that
// float4 reads (f32) and ldmatrix rows (bf16) of eight consecutive rows
// fall on distinct banks.
template <typename T>
constexpr int kV = 16 / int(sizeof(T));

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16 bytes of T as f32 values, and back (rounded once).
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(const uint4& u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}
template <typename T, int E>
__device__ __forceinline__ void store_row(T* dst, const float (&v)[E]) {
  if constexpr (kIsBf16<T>) {
    __nv_bfloat162 h[E / 2];
#pragma unroll
    for (int i = 0; i < E / 2; ++i)
      h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    if constexpr (E == 8)
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<uint4*>(h);
    else
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<uint2*>(h);
  } else {
    static_assert(E == 4, "f32 rows of four");
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
}

// Lc = cumsum(da) over the chunk's rows into lc[0..kMaxQ) (rows past the
// chunk or L read as da = 0), by the first warp. The caller syncs.
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ da,
                                             float* lc, int b, int h, int t0,
                                             int L, int H, int Q) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  constexpr int R = kMaxQ / 32;
  float v[R];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int r = tid * R + k, t = t0 + r;
    s += (r < Q && t < L) ? da[(static_cast<size_t>(b) * L + t) * H + h]
                          : 0.f;
    v[k] = s;
  }
  float incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += o;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (tid == 0) excl = 0.f;
#pragma unroll
  for (int k = 0; k < R; ++k) lc[tid * R + k] = v[k] + excl;
}

// Rows [0, ROWS) x columns [0, COLS) of T from src (row stride ld) into
// shared dst (row stride LDS) by 16-byte cp.async when `vec` (rows start
// on 16 bytes and vcols is whole chunks), else element by element; rows
// at or past vrows and columns at or past vcols read as zero. Chunk c of
// the NT threads' copies is row c / (COLS / V), so a warp reads whole
// rows.
template <typename T, int ROWS, int COLS, int LDS, int NT>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, long long ld,
                                          int vrows, int vcols, bool vec) {
  constexpr int V = kV<T>, CPR = COLS / V, CH = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (CH + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (CH % NT == 0 || c < CH) {
      const int r = c / CPR, q = (c % CPR) * V;
      T* d = dst + r * LDS + q;
      const T* s = src + r * ld + q;
      if (vec) {
        const bool ok = r < vrows && q < vcols;
        cp_async16(smem_addr(d), ok ? s : src, ok);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e)
          d[e] = r < vrows && q + e < vcols ? s[e] : from_f32<T>(0.f);
      }
    }
  }
}

// Calls f(r, q) for each 16-byte chunk (row r, first column q) that
// copy_tile<T, ROWS, COLS, *, NT> gives this thread: a thread transforms
// the chunks it copied itself once its own copies have landed.
template <typename T, int ROWS, int COLS, int NT, typename F>
__device__ __forceinline__ void own_chunks(F f) {
  constexpr int V = kV<T>, CPR = COLS / V, CH = ROWS * CPR;
#pragma unroll
  for (int i = 0; i < (CH + NT - 1) / NT; ++i) {
    const int c = threadIdx.x + i * NT;
    if (CH % NT == 0 || c < CH) f(c / CPR, (c % CPR) * V);
  }
}

// The S-stage ring of a block: item t + S - 1 is copied in while item t
// is multiplied. issue(t) starts item t's copies into stage t % S;
// stage(t) transforms the chunks this thread copied for item t; compute(t)
// multiplies it. One barrier an item: after it, item t is in for every
// thread and every thread is done with item t - 1, whose stage the next
// issue refills. begin() runs once the first S - 1 items are issued
// (copies issued before the ring share item 0's group).
template <int S, typename Issue, typename Stage, typename Compute,
          typename Begin>
__device__ __forceinline__ void ring(int n, Issue issue, Stage stage,
                                     Compute compute, Begin begin) {
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n) issue(t);
    cp_async_commit();
  }
  begin();
  for (int t = 0; t < n; ++t) {
    cp_async_wait<S - 2>();
    stage(t);
    __syncthreads();
    if (t + S - 1 < n) issue(t + S - 1);
    cp_async_commit();
    compute(t);
  }
  cp_async_wait<0>();
}

// ------------------------------------------------------ 1. C B^T tiles

template <typename T>
struct CbShape {
  static constexpr int kLds = kMaxN + kV<T>;     // C and B rows
  static constexpr int kBytes = 2 * kTile * kLds * int(sizeof(T));
};

// Tile (it, jt) of the chunk's lower block triangle: C rows of tile it
// times B rows of tile jt over the N state columns (zero-padded to 16).
template <typename T>
__global__ void __launch_bounds__(kOutThreads)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, int L, int N, int Q, int Qp,
              long long bc_batch, long long bc_row, int vec) {
  constexpr int LDS = CbShape<T>::kLds;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);       // (64, LDS) C rows
  T* bs = cs + kTile * LDS;                     // (64, LDS) B rows
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= static_cast<int>(blockIdx.x)) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, rows = min(Q, L - t0);
  const int i0 = it * kTile, j0 = jt * kTile;
  const long long at = b * bc_batch + static_cast<long long>(t0) * bc_row;
  copy_tile<T, kTile, kMaxN, LDS, kOutThreads>(
      cs, cm + at + i0 * bc_row, bc_row, rows - i0, N, vec);
  copy_tile<T, kTile, kMaxN, LDS, kOutThreads>(
      bs, bm + at + j0 * bc_row, bc_row, rows - j0, N, vec);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int NP = (N + 15) & ~15;
  float* out = cb + (static_cast<size_t>(b) * gridDim.y + c) * Qp * Qp;
  const int tid = threadIdx.x;
  if constexpr (kIsBf16<T>) {
    // warp w: rows 16 w .. 16 w + 15, all 64 columns (8 n8 fragments)
    const int lane = tid & 31, w = tid >> 5;
    float acc[8][4] = {};
    for (int k0 = 0; k0 < NP; k0 += 16) {
      unsigned a[4];
      ldmatrix_x4(a, cs + (16 * w + (lane & 15)) * LDS + k0 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        unsigned bq[4];
        ldmatrix_x4(bq, bs + (16 * nb + (lane & 7) + ((lane >> 4) << 3)) * LDS +
                            k0 + ((lane >> 3) & 1) * 8);
        mma_bf16(acc[2 * nb], a, bq[0], bq[1]);
        mma_bf16(acc[2 * nb + 1], a, bq[2], bq[3]);
      }
    }
    const int r = i0 + 16 * w + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      float* o = out + static_cast<size_t>(r) * Qp + j0 + 8 * nt +
                 (lane & 3) * 2;
      *reinterpret_cast<float2*>(o) = make_float2(acc[nt][0], acc[nt][1]);
      *reinterpret_cast<float2*>(o + 8 * Qp) =
          make_float2(acc[nt][2], acc[nt][3]);
    }
  } else {
    // thread (tx, ty): rows ty + 16 a, columns tx + 8 q
    const int tx = tid % 8, ty = tid / 8;
    float acc[4][8] = {};
#pragma unroll 2
    for (int k = 0; k < NP; k += 4) {
      float4 cv[4], bv[8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        cv[a] = *reinterpret_cast<const float4*>(cs + (ty + 16 * a) * LDS + k);
#pragma unroll
      for (int q = 0; q < 8; ++q)
        bv[q] = *reinterpret_cast<const float4*>(bs + (tx + 8 * q) * LDS + k);
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          float s = acc[a][q];
          s = fmaf(cv[a].x, bv[q].x, s);
          s = fmaf(cv[a].y, bv[q].y, s);
          s = fmaf(cv[a].z, bv[q].z, s);
          acc[a][q] = fmaf(cv[a].w, bv[q].w, s);
        }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        out[static_cast<size_t>(i0 + ty + 16 * a) * Qp + j0 + tx + 8 * q] =
            acc[a][q];
  }
}

// ------------------------------------------------------ 2. chunk states


template <typename T, int PS>
struct StateShape {
  static constexpr int kThreads = 2 * PS;
  // ring stages: f32 multiplies long enough per item that two stages
  // keep three blocks an SM (78 KB with three); bf16 needs the depth
  static constexpr int kS = kIsBf16<T> ? 3 : 2;
  static constexpr int kLb = kMaxN + kV<T>;      // B rows (state columns)
  static constexpr int kLx = PS + kV<T>;         // xt rows
  static constexpr int kStage = kKC * (kLb + kLx);
  static constexpr int kBytes =
      2 * kMaxQ * 4 + kS * kStage * int(sizeof(T));
};

// S_c (PS rows of P x the N state columns) = sum over the chunk's rows j
// of (xt_j exp(Lc_last - Lc_j)) B_j, K = j in items of 32 rows, B and xt
// by cp.async, xt decayed in place (bf16: rounded once) by the thread
// that copied it. f32: thread (tx, ty) owns p = 4 tx + {0..3}, PS/2 +
// 4 tx + {0..3} and n = 4 ty + {0..3}, 64 + 4 ty + {0..3}. bf16: warp w
// owns p rows 16 w .. 16 w + 15 and every n (M = p, N = n).
template <typename T, int PS>
__global__ void __launch_bounds__(StateShape<T, PS>::kThreads)
ssd_state_kernel(const T* __restrict__ xt, const float* __restrict__ da,
                 const T* __restrict__ bm, float* __restrict__ hs,
                 float* __restrict__ dec, float* __restrict__ lcs, int L,
                 int H, int P, int N, int Q, int Qp, int n_chunks,
                 long long bc_batch, long long bc_row, int vec) {
  using S = StateShape<T, PS>;
  constexpr int NT = S::kThreads, LB = S::kLb, LX = S::kLx, V = kV<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lc = reinterpret_cast<float*>(smem_raw);    // (kMaxQ) Lc
  float* wend = lc + kMaxQ;                          // exp(Lc_last - Lc_j)
  T* ring_base = reinterpret_cast<T*>(wend + kMaxQ); // stages: (B, xt)

  const int c = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * PS;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int t0 = c * Q, rows = min(Q, L - t0);
  const size_t x_row = static_cast<size_t>(H) * P;
  const T* xb = xt + (static_cast<size_t>(b) * L + t0) * x_row +
                static_cast<size_t>(h) * P + p0;
  const T* bb = bm + b * bc_batch + static_cast<long long>(t0) * bc_row;

  chunk_cumsum(da, lc, b, h, t0, L, H, Q);
  __syncthreads();
  const float lc_last = lc[Q - 1];
  for (int r = tid; r < kMaxQ; r += NT) wend[r] = expf(lc_last - lc[r]);
  const size_t bch = (static_cast<size_t>(b) * n_chunks + c) * H + h;
  if (blockIdx.y == 0) {               // the chunk's decay and Lc, once
    if (tid == 0) dec[bch] = expf(lc_last);
    for (int r = tid; r < Qp; r += NT) lcs[bch * Qp + r] = lc[r];
  }
  __syncthreads();                     // wend is read by stage

  const int NP = (N + 15) & ~15;
  float acc[64];                       // bf16: 16 n8 fragments; f32: 8 x 8
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  const int lane = tid & 31, w = tid >> 5;
  const int tx = tid % (PS / 8), ty = tid / (PS / 8);

  auto issue = [&](int t) {
    T* sb = ring_base + (t % S::kS) * S::kStage;
    const int j0 = t * kKC;
    copy_tile<T, kKC, kMaxN, LB, NT>(sb, bb + j0 * bc_row, bc_row, rows - j0,
                                     N, vec);
    copy_tile<T, kKC, PS, LX, NT>(sb + kKC * LB, xb + j0 * x_row,
                                  static_cast<long long>(x_row), rows - j0,
                                  PS, true);
  };
  auto stage = [&](int t) {
    T* sx = ring_base + (t % S::kS) * S::kStage + kKC * LB;
    const int j0 = t * kKC;
    own_chunks<T, kKC, PS, NT>([&](int r, int q) {
      T* at = sx + r * LX + q;
      float v[V];
      unpack(*reinterpret_cast<const uint4*>(at), v);
      const float wj = wend[j0 + r];
#pragma unroll
      for (int e = 0; e < V; ++e) v[e] *= wj;
      store_row<T, V>(at, v);
    });
  };
  auto compute = [&](int t) {
    const T* sb = ring_base + (t % S::kS) * S::kStage;
    const T* sx = sb + kKC * LB;
    if constexpr (kIsBf16<T>) {
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 16) {
        unsigned a[4];
        ldmatrix_x4_trans(a, sx + (k0 + (lane & 7) + ((lane >> 4) << 3)) * LX +
                                 16 * w + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int np = 0; np < kMaxN / 16; ++np) {
          if (16 * np < NP) {
            unsigned bq[4];
            ldmatrix_x4_trans(
                bq, sb + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LB +
                        16 * np + (lane >> 4) * 8);
            mma_bf16(acc + 8 * np, a, bq[0], bq[1]);
            mma_bf16(acc + 8 * np + 4, a, bq[2], bq[3]);
          }
        }
      }
    } else {
#pragma unroll 4
      for (int k = 0; k < kKC; ++k) {
        const float* xk = reinterpret_cast<const float*>(sx) + k * LX;
        const float* bk = reinterpret_cast<const float*>(sb) + k * LB;
        const float4 x0 = *reinterpret_cast<const float4*>(xk + 4 * tx);
        const float4 x1 =
            *reinterpret_cast<const float4*>(xk + PS / 2 + 4 * tx);
        const float4 b0 = *reinterpret_cast<const float4*>(bk + 4 * ty);
        const float4 b1 = *reinterpret_cast<const float4*>(bk + 64 + 4 * ty);
        const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            acc[p * 8 + n] = fmaf(xv[p], bv[n], acc[p * 8 + n]);
      }
    }
  };
  ring<S::kS>((rows + kKC - 1) / kKC, issue, stage, compute, [] {});

  float* out = hs + ((static_cast<size_t>(b) * n_chunks + c) * H + h) * P * N;
  const bool v4 = (N & 3) == 0;
  if constexpr (kIsBf16<T>) {
#pragma unroll
    for (int nt = 0; nt < kMaxN / 8; ++nt) {
      const int n = 8 * nt + (lane & 3) * 2;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float* o = out + static_cast<size_t>(p0 + 16 * w + (lane >> 2) +
                                             8 * hf) * N + n;
        const float* a = acc + 4 * nt + 2 * hf;
        if (v4 && n < N) {
          *reinterpret_cast<float2*>(o) = make_float2(a[0], a[1]);
        } else {
          if (n < N) o[0] = a[0];
          if (n + 1 < N) o[1] = a[1];
        }
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      const int pp = p0 + (p < 4 ? 4 * tx + p : PS / 2 + 4 * tx + p - 4);
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        const int n = 64 * g + 4 * ty;
        float* o = out + static_cast<size_t>(pp) * N + n;
        const float* a = acc + p * 8 + 4 * g;
        if (v4 && n < N) {
          *reinterpret_cast<float4*>(o) = make_float4(a[0], a[1], a[2], a[3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + e < N) o[e] = a[e];
        }
      }
    }
  }
}

// ------------------------------------------------------ 3. state pass

constexpr int kPassThreads = 256;
constexpr int kAhead = 8;              // chunk states read ahead

// One block a (32 p x 32 n) tile of a (sequence, head)'s state: thread
// (lx, ly) carries (p0 + ly + 8 k, n0 + lx), k < 4, through the chunks in
// order, h_{c+1} = h_c dec_c + S_c in f32 from h0 (or zero), reading
// kAhead chunks' S_c ahead of the chain. Each h_c goes out transposed,
// through a shared tile, as the output kernel's operand: ht (B,
// n_chunks, H, N, P) in T (bf16: rounded once). The final state goes to
// h_out in the cache's (B, H, P, N) layout.
template <typename T>
__global__ void __launch_bounds__(kPassThreads)
ssd_pass_kernel(const float* __restrict__ h0, const float* __restrict__ hs,
                const float* __restrict__ dec, T* __restrict__ ht,
                float* __restrict__ h_out, int H, int P, int N,
                int n_chunks) {
  __shared__ float tile[2][32][33];
  const int tiles_n = (N + 31) / 32;
  const int n0 = (blockIdx.x % tiles_n) * 32, p0 = (blockIdx.x / tiles_n) * 32;
  const int h = blockIdx.y, b = blockIdx.z;
  const int lx = threadIdx.x & 31, ly = threadIdx.x >> 5;
  const size_t PN = static_cast<size_t>(P) * N;
  const size_t step = static_cast<size_t>(H) * PN;    // one chunk's states
  const size_t base = (static_cast<size_t>(b) * n_chunks * H + h) * PN;
  const size_t hb = (static_cast<size_t>(b) * H + h) * PN;
  const float* db = dec + static_cast<size_t>(b) * n_chunks * H + h;
  float s[4];
  bool ok[4];
  int off[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = p0 + ly + 8 * k, n = n0 + lx;
    ok[k] = p < P && n < N;
    off[k] = p * N + n;
    s[k] = ok[k] && h0 ? h0[hb + off[k]] : 0.f;
  }
  for (int c0 = 0; c0 < n_chunks; c0 += kAhead) {
    float upd[kAhead][4];
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        upd[a][k] = c0 + a < n_chunks && ok[k]
                        ? hs[base + (c0 + a) * step + off[k]]
                        : 0.f;
#pragma unroll
    for (int a = 0; a < kAhead; ++a) {
      const int c = c0 + a;
      if (c < n_chunks) {
        float(*tl)[33] = tile[c & 1];
#pragma unroll
        for (int k = 0; k < 4; ++k) tl[ly + 8 * k][lx] = s[k];
        __syncthreads();               // tile c & 1 was read at chunk c - 2
        T* dst = ht + base + c * step;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int p = p0 + lx, n = n0 + ly + 8 * k;
          if (p < P && n < N)
            dst[static_cast<size_t>(n) * P + p] =
                from_f32<T>(tl[lx][ly + 8 * k]);
        }
        const float d = db[static_cast<size_t>(c) * H];
#pragma unroll
        for (int k = 0; k < 4; ++k) s[k] = fmaf(s[k], d, upd[a][k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (ok[k]) h_out[hb + off[k]] = s[k];
}

// ------------------------------------------------------ 4. outputs

template <typename T, int PS>
struct OutShape {
  static constexpr int kLa = kKC + kV<T>;        // A rows: C or scores
  static constexpr int kLb = PS + kV<T>;         // B rows: h_c^T or xt
  // bf16 stages the f32 C B^T item before its scores are rounded
  static constexpr int kStaged = kIsBf16<T> ? kTile * kKC * 4 : 0;
  static constexpr int kStage =
      (kTile * kLa + kKC * kLb) * int(sizeof(T)) + kStaged;   // bytes
  // Lc, exp(Lc_i - Lc_i0) of the tile's rows, exp(Lc_i0 - Lc_j), j < i0
  static constexpr int kHead = (2 * kMaxQ + kTile) * 4;
  static constexpr int kS = 2;                   // ring stages
  static constexpr int kBytes = kHead + kS * kStage;
};

// y rows i0 .. i0 + 63 of (chunk, head), columns p0 .. p0 + PS - 1. The
// items, all by cp.async: first the state's, n0 = 32 m (A = C[i, n0 ..],
// B = h_c^T[n0 .., p] from the pass); then exp(Lc_i) scales the sums;
// then the scores', j0 = 32 m up to the tile's last real row (A = C B^T
// [i, j0 ..], decayed and masked in place by the thread that copied it,
// bf16 rounding it from an f32 staging tile; B = xt[j0 ..]). The decay:
// below the tile (j < i0) as exp(Lc_i - Lc_i0) exp(Lc_i0 - Lc_j), two
// factors of at most 1 computed once a block; in the tile's own 64
// columns exp(Lc_i - Lc_j) where i >= j and 0 above the diagonal. Row
// groups wholly above the diagonal skip an item. f32: thread (tx, ty)
// owns rows ty + TY a (TY = 128 / (PS/8)) and columns 4 tx + {0..3},
// PS/2 + 4 tx + {0..3}. bf16: warp w owns rows 16 w .. 16 w + 15 and the
// slice's PS columns.
template <typename T, int PS>
__global__ void __launch_bounds__(kOutThreads, 5)
ssd_out_kernel(const T* __restrict__ xt, const float* __restrict__ lcs,
               const T* __restrict__ cm, const float* __restrict__ cb,
               const T* __restrict__ ht, T* __restrict__ y, int L, int H,
               int P, int N, int Q, int Qp, int n_chunks, long long bc_batch,
               long long bc_row, int vec) {
  using S = OutShape<T, PS>;
  constexpr int NT = kOutThreads, LA = S::kLa, LB = S::kLb;
  constexpr int TX = PS / 8, TY = NT / TX, RM = kTile / TY;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* lc = reinterpret_cast<float*>(smem_raw);    // (kMaxQ) Lc
  float* colf = lc + kMaxQ;                          // exp(Lc_i0 - Lc_j)
  float* rowf = colf + kMaxQ;                        // exp(Lc_i - Lc_i0)
  unsigned char* ring_base = smem_raw + S::kHead;    // stages: (A, B, f32)

  // the row tiles of one (chunk, head) are neighbours, heaviest first
  const int n_rt = Qp / kTile;
  const int it = n_rt - 1 - static_cast<int>(blockIdx.x) % n_rt;
  const int g = blockIdx.x / n_rt, c = g / H, h = g % H;
  const int p0 = blockIdx.y * PS, b = blockIdx.z;
  const int t0 = c * Q, rows = min(Q, L - t0), i0 = it * kTile;
  if (i0 >= rows) return;              // a short last chunk's empty tile
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const size_t x_row = static_cast<size_t>(H) * P;
  const size_t x_at = (static_cast<size_t>(b) * L + t0) * x_row +
                      static_cast<size_t>(h) * P + p0;
  const T* cmb = cm + b * bc_batch + static_cast<long long>(t0 + i0) * bc_row;
  const float* cbt = cb + (static_cast<size_t>(b) * n_chunks + c) * Qp * Qp +
                     static_cast<size_t>(i0) * Qp;
  const T* htc = ht + ((static_cast<size_t>(b) * n_chunks + c) * H + h) *
                          P * N + p0;

  // the chunk's Lc (from the state kernel), with item 0's copies
  copy_tile<float, 1, kMaxQ, kMaxQ, NT>(
      lc, lcs + ((static_cast<size_t>(b) * n_chunks + c) * H + h) * Qp, 0, 1,
      Qp, true);

  const int ni = (N + kKC - 1) / kKC;
  const int n_items = ni + (min(i0 + kTile, rows) + kKC - 1) / kKC;
  auto tile_a = [&](int t) {
    return reinterpret_cast<T*>(ring_base + (t % S::kS) * S::kStage);
  };
  auto issue = [&](int t) {
    T* sa = tile_a(t);
    T* sb = sa + kTile * LA;
    if (t < ni) {
      const int n0 = t * kKC;
      copy_tile<T, kTile, kKC, LA, NT>(sa, cmb + n0, bc_row, rows - i0,
                                       N - n0, vec);
      copy_tile<T, kKC, PS, LB, NT>(sb, htc + static_cast<size_t>(n0) * P, P,
                                    N - n0, PS, true);
    } else {
      const int j0 = (t - ni) * kKC;
      float* sg = kIsBf16<T> ? reinterpret_cast<float*>(sb + kKC * LB)
                             : reinterpret_cast<float*>(sa);
      copy_tile<float, kTile, kKC, kIsBf16<T> ? kKC : LA, NT>(
          sg, cbt + j0, Qp, kTile, kKC, true);
      copy_tile<T, kKC, PS, LB, NT>(sb, xt + x_at + j0 * x_row,
                                    static_cast<long long>(x_row), rows - j0,
                                    PS, true);
    }
  };
  auto stage = [&](int t) {
    if (t < ni) return;
    T* sa = tile_a(t);
    const int j0 = (t - ni) * kKC;
    const float* sg = kIsBf16<T>
                          ? reinterpret_cast<const float*>(sa + kTile * LA +
                                                           kKC * LB)
                          : reinterpret_cast<const float*>(sa);
    constexpr int LG = kIsBf16<T> ? kKC : LA;
    const bool below = j0 + kKC <= i0;   // every j of the item < i0
    own_chunks<float, kTile, kKC, NT>([&](int r, int q) {
      const float4 gv = *reinterpret_cast<const float4*>(sg + r * LG + q);
      const float g4[4] = {gv.x, gv.y, gv.z, gv.w};
      const int i = i0 + r;
      float v[4];
      if (below) {
        const float fr = rowf[r];
        const float4 cf = *reinterpret_cast<const float4*>(colf + j0 + q);
        const float c4[4] = {cf.x, cf.y, cf.z, cf.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = g4[e] * fr * c4[e];
      } else {
        const float li = lc[i];
        const float4 lj = *reinterpret_cast<const float4*>(lc + j0 + q);
        const float l4[4] = {lj.x, lj.y, lj.z, lj.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = i >= j0 + q + e ? g4[e] * exp2f((li - l4[e]) * kLog2e)
                                 : 0.f;
      }
      store_row<T, 4>(sa + r * LA + q, v);
    });
  };

  constexpr int kAcc = kIsBf16<T> ? PS / 2 : RM * 8;   // PS/8 n8 x 4
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int tx = tid % TX, ty = tid / TX;

  auto compute = [&](int t) {
    const T* sa = tile_a(t);
    const T* sb = sa + kTile * LA;
    if (t == ni) {                     // the state's term times exp(Lc_i)
      if constexpr (kIsBf16<T>) {
        const float e0 = expf(lc[i0 + 16 * w + (lane >> 2)]);
        const float e1 = expf(lc[i0 + 16 * w + (lane >> 2) + 8]);
#pragma unroll
        for (int nt = 0; nt < PS / 8; ++nt) {
          acc[4 * nt] *= e0;
          acc[4 * nt + 1] *= e0;
          acc[4 * nt + 2] *= e1;
          acc[4 * nt + 3] *= e1;
        }
      } else {
#pragma unroll
        for (int a = 0; a < RM; ++a) {
          const float e = expf(lc[i0 + ty + TY * a]);
#pragma unroll
          for (int q = 0; q < 8; ++q) acc[a * 8 + q] *= e;
        }
      }
    }
    if constexpr (kIsBf16<T>) {
#pragma unroll
      for (int k0 = 0; k0 < kKC; k0 += 16) {
        if (t >= ni && (t - ni) * kKC + k0 > i0 + 16 * w + 15) continue;
        unsigned a[4];
        ldmatrix_x4(a, sa + (16 * w + (lane & 15)) * LA + k0 + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < PS / 16; ++np) {
          unsigned bq[4];
          ldmatrix_x4_trans(bq, sb + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         LB + 16 * np + (lane >> 4) * 8);
          mma_bf16(acc + 8 * np, a, bq[0], bq[1]);
          mma_bf16(acc + 8 * np + 4, a, bq[2], bq[3]);
        }
      }
    } else {
      // rows ty + TY a for a >= A0 (the lower half of the tile when the
      // item lies in the tile's upper-right half)
      const auto fma_rows = [&](auto a0) {
        constexpr int A0 = decltype(a0)::value;
        const float* af = reinterpret_cast<const float*>(sa);
        const float* bf = reinterpret_cast<const float*>(sb);
#pragma unroll 2
        for (int k = 0; k < kKC; k += 4) {
          float4 av[RM];
#pragma unroll
          for (int a = A0; a < RM; ++a)
            av[a] =
                *reinterpret_cast<const float4*>(af + (ty + TY * a) * LA + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 b0 =
                *reinterpret_cast<const float4*>(bf + (k + kk) * LB + 4 * tx);
            const float4 b1 = *reinterpret_cast<const float4*>(
                bf + (k + kk) * LB + PS / 2 + 4 * tx);
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w,
                                 b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int a = A0; a < RM; ++a) {
              const float sv = kk == 0 ? av[a].x : kk == 1 ? av[a].y
                             : kk == 2 ? av[a].z : av[a].w;
#pragma unroll
              for (int q = 0; q < 8; ++q)
                acc[a * 8 + q] = fmaf(sv, bv[q], acc[a * 8 + q]);
            }
          }
        }
      };
      if (RM >= 2 && t >= ni && (t - ni) * kKC >= i0 + kTile / 2)
        fma_rows(std::integral_constant<int, RM / 2>{});
      else
        fma_rows(std::integral_constant<int, 0>{});
    }
  };
  const auto begin = [&] {
    // Lc is in (group 0): the decay factors of the rows below the tile
    cp_async_wait<S::kS - 2>();
    __syncthreads();
    const float l0 = lc[i0];
    for (int k = tid; k < kTile + i0; k += NT) {
      if (k < kTile)
        rowf[k] = expf(lc[i0 + k] - l0);
      else
        colf[k - kTile] = expf(l0 - lc[k - kTile]);
    }
    __syncthreads();
  };
  ring<S::kS>(n_items, issue, stage, compute, begin);

  T* yb = y + x_at;
  if constexpr (kIsBf16<T>) {
    // the tile, rounded once, through shared memory (the ring is done) so
    // that each row leaves in 16-byte pieces
    constexpr int LY = PS + 8;
    T* ys = reinterpret_cast<T*>(ring_base);
    __syncthreads();
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = 16 * w + (lane >> 2) + 8 * hf;
#pragma unroll
      for (int nt = 0; nt < PS / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(ys + r * LY + 8 * nt +
                                           (lane & 3) * 2) =
            __floats2bfloat162_rn(acc[4 * nt + 2 * hf],
                                  acc[4 * nt + 2 * hf + 1]);
    }
    __syncthreads();
    constexpr int CPR = PS / 8;
#pragma unroll
    for (int i = 0; i < kTile * CPR / NT; ++i) {
      const int ch = tid + i * NT, r = ch / CPR, q = (ch % CPR) * 8;
      if (i0 + r < rows)
        *reinterpret_cast<uint4*>(yb + static_cast<size_t>(i0 + r) * x_row +
                                  q) =
            *reinterpret_cast<const uint4*>(ys + r * LY + q);
    }
  } else {
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      const int r = ty + TY * a;
      if (i0 + r < rows) {
        float* yr = reinterpret_cast<float*>(yb) +
                    static_cast<size_t>(i0 + r) * x_row;
        *reinterpret_cast<float4*>(yr + 4 * tx) =
            make_float4(acc[a * 8], acc[a * 8 + 1], acc[a * 8 + 2],
                        acc[a * 8 + 3]);
        *reinterpret_cast<float4*>(yr + PS / 2 + 4 * tx) =
            make_float4(acc[a * 8 + 4], acc[a * 8 + 5], acc[a * 8 + 6],
                        acc[a * 8 + 7]);
      }
    }
  }
}

// The dynamic shared-memory attribute of each kernel of one (T, PS), set
// once: every size is fixed by the instantiation.
template <typename T, int PS>
cudaError_t allow_smem_once() {
  static const cudaError_t err = [] {
    const auto set = [](const void* kern, int bytes) {
      return cudaFuncSetAttribute(kern,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes);
    };
    cudaError_t e = set(reinterpret_cast<const void*>(ssd_cb_kernel<T>),
                        CbShape<T>::kBytes);
    if (e == cudaSuccess)
      e = set(reinterpret_cast<const void*>(ssd_state_kernel<T, PS>),
              StateShape<T, PS>::kBytes);
    if (e == cudaSuccess)
      e = set(reinterpret_cast<const void*>(ssd_out_kernel<T, PS>),
              OutShape<T, PS>::kBytes);
    return e;
  }();
  return err;
}

// Offsets of the scratch regions in one buffer, each on 256 bytes: cb
// (B, n_chunks, Qp, Qp) f32, hs (B, n_chunks, H, P, N) f32, dec (B,
// n_chunks, H) f32, lcs (B, n_chunks, H, Qp) f32, ht (B, n_chunks, H, N,
// P) in T.
struct Scratch {
  size_t cb, hs, dec, lcs, ht, bytes;
  Scratch(int B, int n_chunks, int Qp, int H, int P, int N, int t_size) {
    const auto up = [](size_t v) { return (v + 255) / 256 * 256; };
    const size_t bc = static_cast<size_t>(B) * n_chunks;
    cb = 0;
    hs = up(cb + 4 * bc * Qp * Qp);
    dec = up(hs + 4 * bc * H * P * N);
    lcs = up(dec + 4 * bc * H);
    ht = up(lcs + 4 * bc * H * Qp);
    bytes = up(ht + static_cast<size_t>(t_size) * bc * H * P * N);
  }
};

template <typename T, int PS>
int launch_ps(const void* xt_, const void* da_, const void* bm_,
              const void* cm_, void* scratch, const void* h0, void* y_,
              void* h_out, int B, int L, int H, int P, int N, int Q,
              long long bc_batch, long long bc_row, cudaStream_t stream) {
  cudaError_t err = allow_smem_once<T, PS>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* xt = static_cast<const T*>(xt_);
  const float* da = static_cast<const float*>(da_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
  const int n_chunks = (L + Q - 1) / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int Qp = n_tiles * kTile;
  const Scratch sc(B, n_chunks, Qp, H, P, N, int(sizeof(T)));
  unsigned char* base = static_cast<unsigned char*>(scratch);
  float* cb = reinterpret_cast<float*>(base + sc.cb);
  float* hs = reinterpret_cast<float*>(base + sc.hs);
  float* dec = reinterpret_cast<float*>(base + sc.dec);
  float* lcs = reinterpret_cast<float*>(base + sc.lcs);
  T* ht = reinterpret_cast<T*>(base + sc.ht);
  // B and C rows by 16-byte copies: both 16-byte aligned, their strides
  // and N whole 16-byte chunks
  constexpr int V = kV<T>;
  const int vec = reinterpret_cast<uintptr_t>(bm_) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(cm_) % 16 == 0 &&
                  bc_batch % V == 0 && bc_row % V == 0 && N % 8 == 0;

  ssd_cb_kernel<T><<<dim3(n_tiles * (n_tiles + 1) / 2, n_chunks, B),
                     kOutThreads, CbShape<T>::kBytes, stream>>>(
      bm, cm, cb, L, N, Q, Qp, bc_batch, bc_row, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_state_kernel<T, PS><<<dim3(n_chunks * H, P / PS, B),
                            StateShape<T, PS>::kThreads,
                            StateShape<T, PS>::kBytes, stream>>>(
      xt, da, bm, hs, dec, lcs, L, H, P, N, Q, Qp, n_chunks, bc_batch,
      bc_row, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_pass_kernel<T><<<dim3(((N + 31) / 32) * ((P + 31) / 32), H, B),
                       kPassThreads, 0, stream>>>(
      static_cast<const float*>(h0), hs, dec, ht,
      static_cast<float*>(h_out), H, P, N, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<T, PS><<<dim3(n_chunks * H * n_tiles, P / PS, B),
                          kOutThreads, OutShape<T, PS>::kBytes, stream>>>(
      xt, lcs, cm, cb, ht, static_cast<T*>(y_), L, H, P, N, Q, Qp, n_chunks,
      bc_batch, bc_row, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xt, const void* da, const void* bm, const void* cm,
           void* scratch, const void* h0, void* y, void* h_out, int B, int L,
           int H, int P, int N, int Q, int PS, long long bc_batch,
           long long bc_row, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P % PS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (PS) {
    case 16:
      return launch_ps<T, 16>(xt, da, bm, cm, scratch, h0, y, h_out, B, L,
                              H, P, N, Q, bc_batch, bc_row, st);
    case 32:
      return launch_ps<T, 32>(xt, da, bm, cm, scratch, h0, y, h_out, B, L,
                              H, P, N, Q, bc_batch, bc_row, st);
    case 64:
      return launch_ps<T, 64>(xt, da, bm, cm, scratch, h0, y, h_out, B, L,
                              H, P, N, Q, bc_batch, bc_row, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Bytes of the one scratch buffer a launch takes (t_size: 4 for f32, 2
// for bf16), n_chunks = ceil(L / Q), Qp = 64 * ceil(Q / 64).
long long ssd_scan_scratch_bytes(int B, int L, int H, int P, int N, int Q,
                                 int t_size) {
  const int n_chunks = (L + Q - 1) / Q;
  const int Qp = (Q + kTile - 1) / kTile * kTile;
  return static_cast<long long>(
      Scratch(B, n_chunks, Qp, H, P, N, t_size).bytes);
}

// Each entry point launches the four kernels on `stream` and returns the
// CUDA error of the launches (0 on success). scratch: at least
// ssd_scan_scratch_bytes, on 256 bytes. h0 may be null (a zero initial
// state). The caller checks shapes: 1 <= Q <= 256, 1 <= N <= 128, PS in
// {16, 32, 64} dividing P, xt and y on 16 bytes, B <= 65535,
// n_chunks * H * ceil(Q / 64) < 2^31, n_chunks <= 65535.
int ssd_scan_f32(const void* xt, const void* da, const void* bm,
                 const void* cm, void* scratch, const void* h0, void* y,
                 void* h_out, int B, int L, int H, int P, int N, int Q,
                 int PS, long long bc_batch, long long bc_row,
                 void* stream) {
  return launch<float>(xt, da, bm, cm, scratch, h0, y, h_out, B, L, H, P,
                       N, Q, PS, bc_batch, bc_row, stream);
}

int ssd_scan_bf16(const void* xt, const void* da, const void* bm,
                  const void* cm, void* scratch, const void* h0, void* y,
                  void* h_out, int B, int L, int H, int P, int N, int Q,
                  int PS, long long bc_batch, long long bc_row,
                  void* stream) {
  return launch<__nv_bfloat16>(xt, da, bm, cm, scratch, h0, y, h_out, B, L,
                               H, P, N, Q, PS, bc_batch, bc_row, stream);
}

}  // extern "C"
