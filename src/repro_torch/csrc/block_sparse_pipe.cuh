// The warp routine of the block-sparse matmuls: kernels 1 and 5
// (block_sparse.cu), the grouped kernels 6 and 8 and the ragged kernels 7
// and 9 (grouped_block_sparse.cu, which point it at one expert's x,
// weight and plan row, or at a 16-row tile of the packed buffer and its
// expert's). One warp computes one (BM-row M-tile, CW-column slice)
// output tile y[r, c] = sum_k x[r, k] * w[k, c] over the live K-blocks
// of the slice's N-block column, in plan order, through its own cp.async
// ring of S stages. Warps never wait on each other: a thread block is
// only a bundle of independent warps.
//
// The walk is a list of items, one per 16 K rows: live step s of the plan
// row and chunk j of its K-block (k = idx[s] * BN + 16 j .. + 15), s in
// plan order, j ascending. Each item stages the x tile (BM x 16) and the
// weight tile (16 x CW) in shared memory with 16-byte cp.async copies,
// S - 1 items ahead of the one being multiplied. The plan row (K-block
// ids; for int8 also storage slots and pow2 scales) is read 32 entries
// at a time, one per lane, the next 32 prefetched, and each item's
// entries are shuffled out one issue ahead, so the copies never wait for
// an index. Each lane's share of the
// copies is fixed but for the K offset and is set up once.
//
// f32 (FFMA, no TF32): lane (tr, tc) of the warp's TR x TC grid owns rows
// tr + TR i and columns 4 tc .. 4 tc + 3 (16 x 8 slices: 16 x 2 lanes,
// one row each; 64 x 16 slices: 8 x 4 lanes, 8 rows each); x and w come
// from shared memory as float4. Each output is one chain of fmaf over the
// items in order, k ascending within an item, starting from 0, so a row
// is bitwise the same at any M-tile and row position: kernels 1 and 5-9
// give one token the same bits. Never split along K in f32.
//
// bf16 (tensor cores): each item is one k16 step of
// mma.sync.m16n8k16.row.col (bf16 in, f32 accumulate): ldmatrix.x4 for
// each 16-row A fragment, ldmatrix.x4.trans for the 16 x 16 weight tile
// (two n8 fragments). The f32 sums run over the items in plan order and
// are rounded to bf16 once at the end; inside a k16 step the order is
// the tensor core's, the same for every row of the tile, so in bf16 too
// the MoE paths (ragged, grouped, per-expert loop) give one token the
// same bits.
//
// int8 kept tiles (kernels 5, 8 and 9): the 16-byte rows of the item's int8
// sub-tile land by cp.async (one a lane) with the step's scale beside
// them; the warp dequantises its columns into one f32 or bf16 tile as
// float(q) * 2^e (exact in f32, and in bf16, whose 8 significant bits
// hold |q| <= 127) and runs the dense code on it: the weights multiplied
// are bitwise those of kernel 1 (kernels 6, 7) over the dequantised
// weight.
#pragma once

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

namespace block_sparse_pipe {

constexpr int kKC = 16;       // K rows per item (one mma k16 step)
constexpr int kMaxWarps = 4;  // warps per thread block, at most

// Output columns per warp: 8 for f32 at 16-row tiles, so that a decode
// launch has twice the warps to share the FFMA issue; 16 otherwise (bf16
// at 16 rows is one m16n8k16 pair per item; at 64 rows a wider slice
// halves the x tiles re-read from L2).
__host__ __device__ constexpr int col_width(bool bf16, int bm) {
  return bm == 16 && !bf16 ? 8 : 16;
}

// Ring depth: 16-row tiles stream small items and need many in flight;
// 64-row tiles carry more x per item.
__host__ __device__ constexpr int stages(bool bf16, int bm, bool int8) {
  return bm == 16 ? (int8 ? 12 : 8) : (bf16 ? 6 : 4);
}

// Warps per thread block: two, so that an SM's blocks spread their warps
// over its four schedulers; four for bf16 at 16-row tiles, whose warps
// issue little and wait long.
__host__ __device__ constexpr int warps(bool bf16, int bm) {
  return bf16 && bm == 16 ? 4 : 2;
}

// Shared-memory rows, in elements: padded so that float4 reads (f32) and
// ldmatrix rows (bf16) of eight consecutive rows hit distinct banks, and
// every row starts on 16 bytes for cp.async.
template <typename T, int CW> struct Rows;
template <int CW> struct Rows<float, CW> {
  static constexpr int kX = kKC + 4;   // 80 B
  static constexpr int kW = CW;        // read as float4 across a row
};
template <int CW> struct Rows<__nv_bfloat16, CW> {
  static constexpr int kX = kKC + 8;   // 48 B
  static constexpr int kW = 24;        // 48 B
};

template <typename T, int BM, bool kInt8>
struct Smem {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kCW = col_width(kBf16, BM);
  static constexpr int kS = stages(kBf16, BM, kInt8);
  static constexpr int kXBytes = BM * Rows<T, kCW>::kX * int(sizeof(T));
  static constexpr int kWBytes =
      kInt8 ? kKC * 16 : kKC * Rows<T, kCW>::kW * int(sizeof(T));
  static constexpr int kStage = kXBytes + kWBytes;
  // int8: the dequantised tile, then one scale per stage
  static constexpr int kDeq =
      kInt8 ? kKC * Rows<T, kCW>::kW * int(sizeof(T)) : 0;
  static constexpr int kScales = kInt8 ? (kS * 4 + 15) / 16 * 16 : 0;
  static constexpr int kWarp = kS * kStage + kDeq + kScales;
};

// One warp's dynamic shared bytes for a launch's types.
inline int warp_bytes(bool bf16, int bm, bool int8) {
  if (bf16) {
    if (bm == 16)
      return int8 ? Smem<__nv_bfloat16, 16, true>::kWarp
                  : Smem<__nv_bfloat16, 16, false>::kWarp;
    return int8 ? Smem<__nv_bfloat16, 64, true>::kWarp
                : Smem<__nv_bfloat16, 64, false>::kWarp;
  }
  if (bm == 16)
    return int8 ? Smem<float, 16, true>::kWarp : Smem<float, 16, false>::kWarp;
  return int8 ? Smem<float, 64, true>::kWarp : Smem<float, 64, false>::kWarp;
}

// The tile a launch takes over `rows` rows (kernels 1 and 5: M; the
// grouped kernels: a panel of block_m rows): 64-row M-tiles from 64
// rows, 16-row ones below. kernels/block_sparse/kernel.py::tile_config
// mirrors it.
struct Config {
  int m_tile, stages, warps, mma, smem;  // mma: 0 FFMA, 1 mma.sync
};

inline Config choose(int rows, bool bf16, bool int8) {
  Config c;
  c.m_tile = rows >= 64 ? 64 : 16;
  c.stages = stages(bf16, c.m_tile, int8);
  c.warps = warps(bf16, c.m_tile);
  c.mma = bf16 ? 1 : 0;
  c.smem = c.warps * warp_bytes(bf16, c.m_tile, int8);
  return c;
}

using namespace mma_sm90;

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// A plan row read 32 entries at a time: lane l holds entry base + l of
// the current window and of the next one. get(s) must be called by the
// whole warp with the same, never decreasing, s.
struct PlanRow {
  const int* row;
  int count, base, cur, nxt;

  __device__ __forceinline__ int load(int at, int lane) const {
    return at + lane < count ? __ldg(row + at + lane) : 0;
  }
  __device__ __forceinline__ void init(const int* r, int n, int lane) {
    row = r;
    count = n;
    base = 0;
    cur = load(0, lane);
    nxt = load(32, lane);
  }
  __device__ __forceinline__ int get(int s, int lane) {
    if (s >= base + 32) {
      base += 32;
      cur = nxt;
      nxt = load(base + 32, lane);
    }
    return __shfl_sync(0xffffffffu, cur, s - base);
  }
};

// One warp's output tile: rows m0 .. m0 + BM - 1 (those below M; the
// grouped kernels pass the end of the tile's panel as M) of
// columns col0 .. col0 + CW - 1, the slice at offset `sub` (0 .. BN - CW)
// of its plan column. idx (and for int8 slots / scales) point at the
// column's plan row of `count` live steps. `smem` is the warp's own
// Smem<T, BM, kInt8>::kWarp bytes.
template <typename T, int BN, int BM, bool kInt8>
__device__ __forceinline__ void warp_tile(
    const T* __restrict__ x, const T* __restrict__ w,
    const int8_t* __restrict__ tiles, const int* idx, const int* slots,
    const float* scales, int count, T* __restrict__ y, int m0, int M, int K,
    int N, int col0, int sub, unsigned char* smem) {
  using L = Smem<T, BM, kInt8>;
  constexpr int S = L::kS;
  constexpr int CW = L::kCW;
  constexpr int kChunks = BN / kKC;       // items per live step
  constexpr int kXS = Rows<T, CW>::kX;
  constexpr int kWS = Rows<T, CW>::kW;
  constexpr int kVec = 16 / int(sizeof(T));  // elements per 16 bytes
  const int lane = threadIdx.x & 31;
  const unsigned sbase = smem_addr(smem);

  // The lane's share of each item's copies, fixed but for the K offset:
  // x row chunks (XN a lane), dense weight row chunks (WN a lane, lanes
  // below WL), int8 tile rows (lanes below 16, CW bytes each).
  constexpr int XC = kKC / kVec;            // 16-byte chunks per x row
  constexpr int XN = BM * XC / 32;
  constexpr int WC = CW / kVec;             // 16-byte chunks per w row
  constexpr int WN = (kKC * WC + 31) / 32;
  constexpr int WL = kKC * WC < 32 ? kKC * WC : 32;
  const T* xsrc[XN];
  unsigned xdst[XN];
  bool xok[XN];
#pragma unroll
  for (int i = 0; i < XN; ++i) {
    const int c = lane + 32 * i, r = c / XC, q = c % XC;
    xok[i] = m0 + r < M;
    xsrc[i] = x + static_cast<size_t>(xok[i] ? m0 + r : 0) * K + q * kVec;
    xdst[i] = (r * kXS + q * kVec) * sizeof(T);
  }
  const T* wsrc[WN];
  unsigned wdst[WN];
  if constexpr (!kInt8) {
#pragma unroll
    for (int i = 0; i < WN; ++i) {
      const int c = lane + 32 * i, r = c / WC, q = c % WC;
      wsrc[i] = w + static_cast<size_t>(r) * N + col0 + q * kVec;
      wdst[i] = L::kXBytes + (r * kWS + q * kVec) * sizeof(T);
    }
  }
  float* scl = reinterpret_cast<float*>(smem + S * L::kStage + L::kDeq);
  T* deq = reinterpret_cast<T*>(smem + S * L::kStage);

  // The plan entries of the next item to issue, fetched one issue ahead
  // so that the shuffles' latency hides behind the multiply.
  PlanRow pidx, pslot, pscale;
  pidx.init(idx, count, lane);
  if constexpr (kInt8) {
    pslot.init(slots, count, lane);
    pscale.init(reinterpret_cast<const int*>(scales), count, lane);
  }
  int next_s = 0, next_j = 0;
  int next_kb = 0, next_slot = 0, next_sc = 0;
  auto fetch = [&]() {
    if (next_s < count) {
      next_kb = pidx.get(next_s, lane);
      if constexpr (kInt8) {
        next_slot = pslot.get(next_s, lane);
        next_sc = pscale.get(next_s, lane);
      }
    }
  };
  fetch();

  // Copy the next item (whose plan entries are fetched) into stage st.
  auto issue = [&](int st) {
    const int k0 = next_kb * BN + next_j * kKC;
    const unsigned stage = sbase + st * L::kStage;
#pragma unroll
    for (int i = 0; i < XN; ++i)
      cp_async16(stage + xdst[i], xsrc[i] + k0, xok[i]);
    if constexpr (!kInt8) {
      const size_t koff = static_cast<size_t>(k0) * N;
#pragma unroll
      for (int i = 0; i < WN; ++i)
        if (WL == 32 || lane < WL)
          cp_async16(stage + wdst[i], wsrc[i] + koff, true);
    } else {
      // the 16-byte row piece that holds the slice's CW columns
      const int8_t* src = tiles + static_cast<size_t>(next_slot) * (BN * BN) +
                          (next_j * kKC + lane) * BN + (sub & ~15);
      if (lane < kKC) cp_async16(stage + L::kXBytes + lane * 16, src, true);
      if (lane == 0) scl[st] = __int_as_float(next_sc);
    }
    if (++next_j == kChunks) {
      next_j = 0;
      ++next_s;
      fetch();
    }
  };

  // accumulators: f32 (RM rows x 4 columns a lane), bf16 (BM/16 x 2
  // mma fragments of 4)
  constexpr int TC = CW / 4, TR = 32 / TC, RM = BM / TR;
  const int tr = lane / TC, tc = lane % TC;
  constexpr int kAcc = L::kBf16 ? (BM / 16) * 8 : RM * 4;
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;

  // acc += the item in stage st. int8 first dequantises its rows into
  // deq: lane -> row lane / 2, columns (lane % 2) CW/2 .. + CW/2 - 1.
  auto multiply = [&](int st) {
    const unsigned char* stage = smem + st * L::kStage;
    const T* xs = reinterpret_cast<const T*>(stage);
    const T* ws = reinterpret_cast<const T*>(stage + L::kXBytes);
    if constexpr (kInt8) {
      constexpr int H = CW / 2;
      const int r = lane >> 1, c0 = (lane & 1) * H;
      const int8_t* q = reinterpret_cast<const int8_t*>(
          stage + L::kXBytes + r * 16 + (sub & 15) + c0);
      const float sc = scl[st];
      T* out = deq + r * kWS + c0;
#pragma unroll
      for (int e = 0; e < H; e += 4) {
        const char4 b = *reinterpret_cast<const char4*>(q + e);
        const float v0 = __fmul_rn(float(b.x), sc);
        const float v1 = __fmul_rn(float(b.y), sc);
        const float v2 = __fmul_rn(float(b.z), sc);
        const float v3 = __fmul_rn(float(b.w), sc);
        if constexpr (L::kBf16) {
          __nv_bfloat162 p[2] = {__floats2bfloat162_rn(v0, v1),
                                 __floats2bfloat162_rn(v2, v3)};
          *reinterpret_cast<uint2*>(out + e) = *reinterpret_cast<uint2*>(p);
        } else {
          *reinterpret_cast<float4*>(out + e) = make_float4(v0, v1, v2, v3);
        }
      }
      __syncwarp();
      ws = deq;
    }
    if constexpr (L::kBf16) {
      static_assert(CW == 16, "bf16 slices are two n8 fragments wide");
      unsigned b[4];
      ldmatrix_x4_trans(b, ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * kWS +
                               (lane >> 4) * 8);
#pragma unroll
      for (int mt = 0; mt < BM / 16; ++mt) {
        unsigned a[4];
        ldmatrix_x4(a, xs + (mt * 16 + (lane & 15)) * kXS + (lane >> 4) * 8);
        mma_bf16(acc + mt * 8, a, b[0], b[1]);
        mma_bf16(acc + mt * 8 + 4, a, b[2], b[3]);
      }
    } else {
      const float* xf = reinterpret_cast<const float*>(xs);
      const float* wf = reinterpret_cast<const float*>(ws);
#pragma unroll
      for (int k4 = 0; k4 < kKC; k4 += 4) {
        float4 xv[RM], wv[4];
#pragma unroll
        for (int i = 0; i < RM; ++i)
          xv[i] = *reinterpret_cast<const float4*>(xf + (tr + i * TR) * kXS +
                                                   k4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wv[kk] = *reinterpret_cast<const float4*>(wf + (k4 + kk) * kWS +
                                                    tc * 4);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int i = 0; i < RM; ++i) {
            const float a = part(xv[i], kk);
            acc[i * 4 + 0] = fmaf(a, wv[kk].x, acc[i * 4 + 0]);
            acc[i * 4 + 1] = fmaf(a, wv[kk].y, acc[i * 4 + 1]);
            acc[i * 4 + 2] = fmaf(a, wv[kk].z, acc[i * 4 + 2]);
            acc[i * 4 + 3] = fmaf(a, wv[kk].w, acc[i * 4 + 3]);
          }
      }
    }
  };

  // The ring: item t is multiplied while items t + 1 .. t + S - 1 are in
  // flight; the slot refilled at turn t (and int8's dequantised tile) was
  // read at turn t - 1, before the warp barrier that starts turn t.
  const int n_items = count * kChunks;
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_items) issue(t);
    cp_async_commit();
  }
  int st = 0, st_next = S - 1;
  for (int t = 0; t < n_items; ++t) {
    cp_async_wait<S - 2>();   // item t has landed (this lane's copies) ...
    __syncwarp();             // ... and every lane's; slot st_next is free
    if (t + S - 1 < n_items) issue(st_next);
    cp_async_commit();
    multiply(st);
    st = st + 1 == S ? 0 : st + 1;
    st_next = st_next + 1 == S ? 0 : st_next + 1;
  }
  cp_async_wait<0>();

  if constexpr (L::kBf16) {
#pragma unroll
    for (int mt = 0; mt < BM / 16; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const float* a = acc + mt * 8 + nt * 4;
        const int r = m0 + mt * 16 + (lane >> 2);
        const int c = col0 + nt * 8 + (lane & 3) * 2;
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(y + static_cast<size_t>(r) * N +
                                             c) =
              __floats2bfloat162_rn(a[0], a[1]);
        if (r + 8 < M)
          *reinterpret_cast<__nv_bfloat162*>(
              y + static_cast<size_t>(r + 8) * N + c) =
              __floats2bfloat162_rn(a[2], a[3]);
      }
  } else {
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = m0 + tr + i * TR;
      if (r < M)
        *reinterpret_cast<float4*>(reinterpret_cast<float*>(y) +
                                   static_cast<size_t>(r) * N + col0 +
                                   tc * 4) =
            make_float4(acc[i * 4], acc[i * 4 + 1], acc[i * 4 + 2],
                        acc[i * 4 + 3]);
    }
  }
}

}  // namespace block_sparse_pipe
