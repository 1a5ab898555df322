// Block-sparse matmuls over a stack of MoE expert weights for Hopper
// (sm_90a): the grouped kernel (all experts' capacity-slot batches in one
// launch) and the ragged kernel (routed tokens packed in 16-row per-expert
// segments, one launch), each over a dense weight stack (kernels 6 and 7)
// or over every expert's kept tiles stored as int8 (kernels 8 and 9).
//
// Replaces the TPU kernels src/repro/kernels/grouped_block_sparse/
// kernel.py: grouped_block_sparse_matmul (_kernel),
// ragged_block_sparse_matmul (_ragged_kernel),
// quant_grouped_block_sparse_matmul (_quant_kernel) and
// quant_ragged_block_sparse_matmul (_quant_ragged_kernel). There the
// stacked plan (with slots and scales for int8) and the occupancy map
// (work) or tile map (tile_expert) are scalar-prefetched, the grid's last
// axis walks max_nnz steps in order, and the index maps of dead steps,
// dead (expert, M-block) pairs and dead tiles are clamped so their copies
// are elided. None of that has a Hopper counterpart: here each warp (or,
// for bf16 at 64-row tiles, each thread block) reads its own plan row and
// occupancy entry, a dead tile writes zeros and returns, a live one walks
// only its live K-blocks. All four kernels run the warp routine of
// kernels 1 and 5 (block_sparse_pipe.cuh).
//
//   grouped: y[e] = x[e] @ w[e]. work (E, M/block_m) marks the (expert,
//            panel) pairs that hold a routed row. One warp owns one
//            (expert, plan column, CW-column slice, M-tile); M-tiles
//            never cross a panel, so a tile is wholly live or wholly
//            dead.
//   ragged:  y[t] = x[t] @ w[tile_expert[t]] per 16-row tile t of the
//            packed buffer; tile_expert[t] < 0 or >= E (padding past the
//            packed total) writes zeros. One warp owns one (tile, plan
//            column, CW-column slice) at a 16-row M-tile, the grid one-
//            dimensional over warps.
//
// Layouts: x (E, M, K) or (M, K), w (E, K, N), y like x with N columns,
// all row-major and contiguous, x, w and the int8 tiles each starting on
// 16 bytes (the cp.async copies); counts (E, N/b) int32; indices (E, N/b,
// max_nnz) int32 K-block ids, edge-padded, ascending within a row; work
// (E, M/block_m) int32; tile_expert (M/16,) int32. The int8 kernels take,
// instead of w, tiles (T, b, b) int8 (every expert's kept tiles
// concatenated in plan order), slots (E, N/b, max_nnz) int32 holding
// absolute storage rows and scales (E, N/b, max_nnz) f32 pow2 factors.
// The plan block b is both the K-block and the N-block, one of {16, 32,
// 64, 128}.
//
// Numerics. f32: every output is one fmaf chain over the live K-blocks in
// plan order, k ascending, from 0 (FFMA, no TF32): the order of kernel 1,
// so a token's f32 row is bitwise equal whether it runs through the
// ragged kernel, the grouped kernel or kernel 1 on its expert alone.
// bf16: all four kernels run kernel 1's mma.sync items in the same order
// (each output one f32 sum over the k16 items in plan order, rounded to
// bf16 once), so a token's bf16 row is bitwise equal across the ragged,
// grouped and per-expert loop paths too. The int8 kernels dequantise on
// load (float(q) * scale, exact in f32 and bf16) and equal kernels 6 and
// 7 over the dequantised stack, bitwise, in both types.
//
// What bounds kernels 6 and 8 on the H100 (qwen3-moe-30b-a3b's pruned
// layer-0 stacks, 128 experts):
// - M 16 (a 4 x 32 prefill's capacity slots): bytes. The least the card
//   must move is every live expert's live weight tiles once (density * K
//   * N * 4 bytes in f32, 2 in bf16, 1 plus 12 of index, slot and scale
//   a step in int8), the live x rows and the output, at 3.35 TB/s; the
//   FLOPs are far below either peak. The warp routine reads the gate
//   stack at 2.8x (f32) and 2.9x (bf16) that bound: each slice's walk is
//   one warp's serial chain of scattered 32-64-byte weight rows.
// - M 240 (a 3072-token prompt at batch 1: 240 capacity rows an expert):
//   operations in f32 (2 * 240 * live area at the 67 TFLOP/s FFMA peak;
//   the gate stack at 2.5x), bytes in bf16, but there the time follows
//   the x and weight tiles the thread blocks read from L2 (about 4 KB a
//   block an item: some 2 GB on the down stack, 3.9 TB/s at its measured
//   time), not the bytes from memory: the down stack sits at 5.2x its
//   bound, 3.4x torch.bmm.
// Kernels 7 and 9 (the ragged kernels; replace the TPU kernels at
// src/repro/kernels/grouped_block_sparse/kernel.py:304 / :341 and :235 /
// :263) serve MoE decode ticks of up to 64 tokens: a tile holds one to 16
// routed rows of one expert, so they are bound by bytes: each live
// expert's live weight tiles once (as above), the packed x rows and the
// output. The FLOPs are far below either peak; what sets the time is the
// latency of each slice's serial walk over scattered weight rows. Their
// design takes the warp routine as kernels 6 and 8 do: a warp a (tile,
// slice) with its own cp.async ring (8 items deep, 12 for int8), the
// plan row shuffled out one item ahead, mma.sync in bf16, one 16-byte
// copy per int8 tile row; warps never wait on each other. A tile's
// slices sit in neighbouring warps, and consecutive tiles of one expert
// follow each other, so an expert with more than 16 routed rows reads
// its weight tiles from L2 on its second tile.
// The first design's five causes of lost time (it ran one 256-thread
// block per 16 x b tile through a shared tile routine), and their repair
// here:
// 1. scalar loads, two shared loads per FMA, a barrier pair per 32-row K
//    chunk, nothing overlapped: 16-byte cp.async rings 4-12 items deep,
//    the plan shuffled out one item ahead, register tiles read as float4
//    (f32) or by ldmatrix (bf16);
// 2. bf16 widened onto the FFMA units: mma.sync m16n8k16 on the tensor
//    cores, f32 sums rounded once;
// 3. int8 a byte a thread: one 16-byte cp.async per tile row, the step's
//    slot and scale fetched with its K-block id;
// 4. a panel taller than 16 rows re-read each live weight tile per
//    16-row tile: 64-row M-tiles from 64-row panels, and the M-tiles of
//    a slice in neighbouring warps or blocks, so they share its tiles in
//    L2;
// 5. a whole thread block waiting on one chain per output: one warp a
//    slice with its own ring, no barrier between warps (f32, and bf16 at
//    16-row tiles).
// bf16 at 64-row tiles takes four warps a block instead, on four
// adjacent slices of one expert, walking the merge of their plan rows
// with one x stage per item for all four (grouped_shared_x_kernel). That
// design was timed beside one warp a slice (the M 240 cases of
// chip_smoke.py, same bits) and was 1.44-1.74x faster on both stacks of
// kernels 6 and 8, so it is kept and the other deleted. f32 stays on one
// warp a slice (the shared stage not timed here; kernel 1 found it
// slower for f32 at 64-row tiles).
#include "block_sparse_pipe.cuh"

namespace {

namespace bsp = block_sparse_pipe;
using bsp::Config;
using bsp::kKC;
using bsp::kMaxWarps;

constexpr int kRows = 16;   // rows of a ragged tile; panels are multiples

// ------------------------------------------------ grouped (kernels 6, 8)

// Zeros in rows m0 .. m0 + BM - 1 (those below m_end) of the CW columns
// at col0 of y (M, N): a dead tile, written by one warp in 16-byte
// stores.
template <typename T, int BM, int CW>
__device__ __forceinline__ void zero_slice(T* __restrict__ y, int m0,
                                           int m_end, int N, int col0) {
  constexpr int kC = CW * int(sizeof(T)) / 16;   // 16-byte pieces a row
  constexpr int kVec = 16 / int(sizeof(T));
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < BM * kC; i += 32) {
    const int r = m0 + i / kC;
    if (r < m_end)
      *reinterpret_cast<uint4*>(y + static_cast<size_t>(r) * N + col0 +
                                (i % kC) * kVec) = make_uint4(0, 0, 0, 0);
  }
}

// The M-tiles of a grouped launch: each panel of block_m rows is cut
// into ceil(block_m / BM) tiles, the last one masked at the panel's end,
// so no tile holds rows of two panels.
struct Tiles {
  int per_panel, n_panels, n_mt;

  __host__ __device__ Tiles(int M, int block_m, int bm)
      : per_panel((block_m + bm - 1) / bm), n_panels(M / block_m),
        n_mt(per_panel * n_panels) {}
};

// warp g of the grid -> (expert, column n, slice, M-tile): the M-tile
// fastest, so the M-tiles of one slice share its weight tiles in L2, and
// the expert outermost.
template <typename T, int BN, int BM, bool kInt8>
__device__ __forceinline__ void grouped_run(
    const T* __restrict__ x, const T* __restrict__ w,
    const int8_t* __restrict__ tiles, const int* __restrict__ counts,
    const int* __restrict__ indices, const int* __restrict__ slots,
    const float* __restrict__ scales, const int* __restrict__ work,
    T* __restrict__ y, int E, int M, int K, int N, int max_nnz,
    int block_m) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = bsp::Smem<T, BM, kInt8>;
  constexpr int CW = L::kCW;
  constexpr int kSlices = BN / CW;
  const int warp = threadIdx.x >> 5;
  const long g = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const Tiles t(M, block_m, BM);
  const long per_expert = static_cast<long>(N / CW) * t.n_mt;
  if (g >= per_expert * E) return;
  const int e = static_cast<int>(g / per_expert);
  const long r = g % per_expert;
  const int mt = static_cast<int>(r % t.n_mt);
  const int rest = static_cast<int>(r / t.n_mt);
  const int sub = (rest % kSlices) * CW;
  const int n = rest / kSlices;
  const int panel = mt / t.per_panel;
  const int m0 = panel * block_m + (mt % t.per_panel) * BM;
  const int m_end = (panel + 1) * block_m;
  const int col0 = n * BN + sub;
  T* ye = y + static_cast<size_t>(e) * M * N;
  if (__ldg(work + static_cast<size_t>(e) * t.n_panels + panel) <= 0) {
    zero_slice<T, BM, CW>(ye, m0, m_end, N, col0);
    return;
  }
  const size_t plan = static_cast<size_t>(e) * (N / BN) + n;
  const size_t row = plan * max_nnz;
  bsp::warp_tile<T, BN, BM, kInt8>(
      x + static_cast<size_t>(e) * M * K,
      kInt8 ? nullptr : w + static_cast<size_t>(e) * K * N, tiles,
      indices + row, kInt8 ? slots + row : nullptr,
      kInt8 ? scales + row : nullptr, __ldg(counts + plan), ye, m0, m_end,
      K, N, col0, sub, smem + warp * L::kWarp);
}

template <typename T, int BN, int BM>
__global__ void __launch_bounds__(kMaxWarps * 32)
grouped_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ counts,
               const int* __restrict__ indices,
               const int* __restrict__ work, T* __restrict__ y, int E, int M,
               int K, int N, int max_nnz, int block_m) {
  grouped_run<T, BN, BM, false>(x, w, nullptr, counts, indices, nullptr,
                                nullptr, work, y, E, M, K, N, max_nnz,
                                block_m);
}

template <typename T, int BN, int BM>
__global__ void __launch_bounds__(kMaxWarps * 32)
quant_grouped_kernel(const T* __restrict__ x,
                     const int8_t* __restrict__ tiles,
                     const int* __restrict__ counts,
                     const int* __restrict__ indices,
                     const int* __restrict__ slots,
                     const float* __restrict__ scales,
                     const int* __restrict__ work, T* __restrict__ y, int E,
                     int M, int K, int N, int max_nnz, int block_m) {
  grouped_run<T, BN, BM, true>(x, nullptr, tiles, counts, indices, slots,
                               scales, work, y, E, M, K, N, max_nnz,
                               block_m);
}

// bf16 at 64-row tiles: a thread block of kGroup warps owns kGroup
// adjacent 16-column slices of one expert at one M-tile. The union of
// their plan rows' K-blocks (ascending) is the walk; each item stages the
// x tile once for all warps and each warp's weight tile only where its
// column holds the K-block. A warp multiplies only its own column's
// items, in its plan order (plan rows are ascending), so every output is
// the chain of the warp routine, and kernel 1's bits.
constexpr int kGroup = 4;

template <bool kInt8>
struct SharedX {
  using T = __nv_bfloat16;
  static constexpr int kBM = 64, kCW = 16, kS = 6;
  static constexpr int kXS = bsp::Rows<T, kCW>::kX;
  static constexpr int kWS = bsp::Rows<T, kCW>::kW;
  static constexpr int kXBytes = kBM * kXS * 2;
  static constexpr int kWBytes = kInt8 ? kKC * 16 : kKC * kWS * 2;
  static constexpr int kStage = kXBytes + kGroup * kWBytes;
  static constexpr int kDeq = kInt8 ? kGroup * kKC * kWS * 2 : 0;
  static constexpr int kScales = kInt8 ? kS * kGroup * 4 : 0;
  // then the merge: K/b words of warp flags, K/b list entries, a count
  static constexpr int kFixed = kS * kStage + kDeq + kScales;
};

inline int shared_x_bytes(bool int8, int K, int block) {
  const int fixed = int8 ? SharedX<true>::kFixed : SharedX<false>::kFixed;
  return fixed + 8 * (K / block) + 16;
}

template <int BN, bool kInt8>
__global__ void __launch_bounds__(kGroup * 32)
grouped_shared_x_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        const int8_t* __restrict__ tiles,
                        const int* __restrict__ counts,
                        const int* __restrict__ indices,
                        const int* __restrict__ slots,
                        const float* __restrict__ scales,
                        const int* __restrict__ work,
                        __nv_bfloat16* __restrict__ y, int M, int K, int N,
                        int max_nnz, int block_m) {
  using T = __nv_bfloat16;
  using L = SharedX<kInt8>;
  constexpr int S = L::kS, BM = L::kBM, CW = L::kCW;
  constexpr int kChunks = BN / kKC;
  constexpr int kXS = L::kXS, kWS = L::kWS;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const Tiles tl(M, block_m, BM);
  const int n_slices = N / CW;
  const long per_expert =
      static_cast<long>((n_slices + kGroup - 1) / kGroup) * tl.n_mt;
  const int e = static_cast<int>(blockIdx.x / per_expert);
  const long r = blockIdx.x % per_expert;
  const int mt = static_cast<int>(r % tl.n_mt);
  const int slice = static_cast<int>(r / tl.n_mt) * kGroup + warp;
  const bool has = slice < n_slices;
  const int col0 = slice * CW, n = col0 / BN, sub = col0 % BN;
  const int panel = mt / tl.per_panel;
  const int m0 = panel * block_m + (mt % tl.per_panel) * BM;
  const int m_end = (panel + 1) * block_m;
  T* ye = y + static_cast<size_t>(e) * M * N;
  if (__ldg(work + static_cast<size_t>(e) * tl.n_panels + panel) <= 0) {
    if (has) zero_slice<T, BM, CW>(ye, m0, m_end, N, col0);
    return;                                   // the whole block
  }
  const size_t plan = static_cast<size_t>(e) * (N / BN) + n;
  const int* idx = indices + plan * max_nnz;
  const int count = has ? __ldg(counts + plan) : 0;

  // The merge: flags[kb] byte w set where warp w's column holds K-block
  // kb, then warp 0 lists the flagged K-blocks in ascending order, each
  // with its 4-bit warp mask.
  const int nkb = K / BN;
  unsigned* flags = reinterpret_cast<unsigned*>(smem + L::kFixed);
  int* list = reinterpret_cast<int*>(flags + nkb);
  int* n_list = list + nkb;
  for (int i = tid; i < nkb; i += kGroup * 32) flags[i] = 0u;
  __syncthreads();
  for (int s = lane; s < count; s += 32)
    reinterpret_cast<unsigned char*>(flags)[__ldg(idx + s) * 4 + warp] = 1;
  __syncthreads();
  if (warp == 0) {
    int total = 0;
    for (int k0 = 0; k0 < nkb; k0 += 32) {
      const int kb = k0 + lane;
      const unsigned f = kb < nkb ? flags[kb] : 0u;
      const unsigned live = __ballot_sync(0xffffffffu, f != 0u);
      if (f) {
        const int mask = (f & 1u) | ((f >> 7) & 2u) | ((f >> 14) & 4u) |
                         ((f >> 21) & 8u);
        list[total + __popc(live & ((1u << lane) - 1u))] = kb | mask << 16;
      }
      total += __popc(live);
    }
    if (lane == 0) *n_list = total;
  }
  __syncthreads();
  const int n_items = *n_list * kChunks;
  const unsigned bit = 1u << (16 + warp);

  // each thread's x chunk (one of 64 rows x two 16-byte pieces) and each
  // lane's weight chunk (dense: one of 16 rows x two pieces; int8: row
  // `lane` of the tile, lanes below 16)
  const T* xe = x + static_cast<size_t>(e) * M * K;
  const int xr = tid >> 1, xq = tid & 1;
  const bool xok = m0 + xr < m_end;
  const T* xsrc = xe + static_cast<size_t>(xok ? m0 + xr : 0) * K + xq * 8;
  const unsigned xdst = (xr * kXS + xq * 8) * 2;
  const T* wsrc = nullptr;
  if constexpr (!kInt8)
    wsrc = w + static_cast<size_t>(e) * K * N +
           static_cast<size_t>(lane >> 1) * N + col0 + (lane & 1) * 8;
  const unsigned wdst =
      L::kXBytes + warp * L::kWBytes +
      (kInt8 ? lane * 16 : ((lane >> 1) * kWS + (lane & 1) * 8) * 2);
  const unsigned sbase = bsp::smem_addr(smem);
  float* scl = reinterpret_cast<float*>(smem + S * L::kStage + L::kDeq);
  T* deq = reinterpret_cast<T*>(smem + S * L::kStage) + warp * kKC * kWS;
  bsp::PlanRow pslot, pscale;
  if constexpr (kInt8) {
    pslot.init(slots + plan * max_nnz, count, lane);
    pscale.init(reinterpret_cast<const int*>(scales + plan * max_nnz),
                count, lane);
  }
  int in_li = 0, in_j = 0, in_s = 0;      // the next item to issue

  auto issue = [&](int st) {
    const int ent = list[in_li];
    const int k0 = (ent & 0xffff) * BN + in_j * kKC;
    const unsigned stage = sbase + st * L::kStage;
    bsp::cp_async16(stage + xdst, xsrc + k0, xok);
    if (ent & bit) {
      if constexpr (!kInt8) {
        bsp::cp_async16(stage + wdst, wsrc + static_cast<size_t>(k0) * N,
                        true);
      } else {
        const int slot = pslot.get(in_s, lane);
        const int sc = pscale.get(in_s, lane);
        const int8_t* src = tiles + static_cast<size_t>(slot) * (BN * BN) +
                            (in_j * kKC + lane) * BN + sub;
        if (lane < kKC) bsp::cp_async16(stage + wdst, src, true);
        if (lane == 0) scl[st * kGroup + warp] = __int_as_float(sc);
      }
      if (in_j == kChunks - 1) ++in_s;
    }
    if (++in_j == kChunks) {
      in_j = 0;
      ++in_li;
    }
  };

  float acc[(BM / 16) * 8];
#pragma unroll
  for (int i = 0; i < (BM / 16) * 8; ++i) acc[i] = 0.f;

  auto multiply = [&](int st) {
    const unsigned char* stage = smem + st * L::kStage;
    const T* xs = reinterpret_cast<const T*>(stage);
    const T* ws =
        reinterpret_cast<const T*>(stage + L::kXBytes + warp * L::kWBytes);
    if constexpr (kInt8) {
      // block_sparse_pipe.cuh's dequantisation, row lane / 2, 8 columns
      const int rr = lane >> 1, c0 = (lane & 1) * 8;
      const int8_t* q = reinterpret_cast<const int8_t*>(ws) + rr * 16 + c0;
      const float sc = scl[st * kGroup + warp];
      T* out = deq + rr * kWS + c0;
#pragma unroll
      for (int c = 0; c < 8; c += 4) {
        const char4 b = *reinterpret_cast<const char4*>(q + c);
        __nv_bfloat162 p[2] = {
            __floats2bfloat162_rn(__fmul_rn(float(b.x), sc),
                                  __fmul_rn(float(b.y), sc)),
            __floats2bfloat162_rn(__fmul_rn(float(b.z), sc),
                                  __fmul_rn(float(b.w), sc))};
        *reinterpret_cast<uint2*>(out + c) = *reinterpret_cast<uint2*>(p);
      }
      __syncwarp();
      ws = deq;
    }
    unsigned b[4];
    bsp::ldmatrix_x4_trans(
        b, ws + ((lane & 7) + ((lane >> 3) & 1) * 8) * kWS + (lane >> 4) * 8);
#pragma unroll
    for (int m = 0; m < BM / 16; ++m) {
      unsigned a[4];
      bsp::ldmatrix_x4(a, xs + (m * 16 + (lane & 15)) * kXS + (lane >> 4) * 8);
      bsp::mma_bf16(acc + m * 8, a, b[0], b[1]);
      bsp::mma_bf16(acc + m * 8 + 4, a, b[2], b[3]);
    }
  };

  // the warp routine's ring, with a block barrier in place of the warp's:
  // every warp's copies of item t have landed, and slot st_next was read
  // by every warp at turn t - 1
#pragma unroll
  for (int t = 0; t < S - 1; ++t) {
    if (t < n_items) issue(t);
    bsp::cp_async_commit();
  }
  int st = 0, st_next = S - 1;
  for (int t = 0; t < n_items; ++t) {
    bsp::cp_async_wait<S - 2>();
    __syncthreads();
    const bool mine = list[t / kChunks] & bit;
    if (t + S - 1 < n_items) issue(st_next);
    bsp::cp_async_commit();
    if (mine) multiply(st);
    st = st + 1 == S ? 0 : st + 1;
    st_next = st_next + 1 == S ? 0 : st_next + 1;
  }
  bsp::cp_async_wait<0>();
  if (!has) return;
#pragma unroll
  for (int m = 0; m < BM / 16; ++m)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const float* a = acc + m * 8 + nt * 4;
      const int rr = m0 + m * 16 + (lane >> 2);
      const int c = col0 + nt * 8 + (lane & 3) * 2;
      if (rr < m_end)
        *reinterpret_cast<__nv_bfloat162*>(ye + static_cast<size_t>(rr) * N +
                                           c) =
            __floats2bfloat162_rn(a[0], a[1]);
      if (rr + 8 < m_end)
        *reinterpret_cast<__nv_bfloat162*>(
            ye + static_cast<size_t>(rr + 8) * N + c) =
            __floats2bfloat162_rn(a[2], a[3]);
    }
}

// ------------------------------------------------- ragged (kernels 7, 9)

// warp g of the grid -> (tile t, column n, slice): the slice fastest and
// the tile outermost, so one tile's slices are neighbours and
// consecutive tiles of one expert follow each other. Every tile is 16
// rows of one expert (or dead), so the warp routine runs it with the
// tile's end as its row bound.
template <typename T, int BN, bool kInt8>
__device__ __forceinline__ void ragged_run(
    const T* __restrict__ x, const T* __restrict__ w,
    const int8_t* __restrict__ tiles, const int* __restrict__ counts,
    const int* __restrict__ indices, const int* __restrict__ slots,
    const float* __restrict__ scales, const int* __restrict__ tile_expert,
    T* __restrict__ y, int M, int K, int N, int E, int max_nnz) {
  extern __shared__ __align__(16) unsigned char smem[];
  using L = bsp::Smem<T, kRows, kInt8>;
  constexpr int CW = L::kCW;
  constexpr int kSlices = BN / CW;
  const int warp = threadIdx.x >> 5;
  const long g = static_cast<long>(blockIdx.x) * (blockDim.x >> 5) + warp;
  const int per_tile = N / CW;
  if (g >= static_cast<long>(per_tile) * (M / kRows)) return;
  const int t = static_cast<int>(g / per_tile);
  const int r = static_cast<int>(g % per_tile);
  const int n = r / kSlices;
  const int sub = (r % kSlices) * CW;
  const int col0 = n * BN + sub;
  const int m0 = t * kRows;
  const int e = __ldg(tile_expert + t);
  if (e < 0 || e >= E) {
    zero_slice<T, kRows, CW>(y, m0, m0 + kRows, N, col0);
    return;
  }
  const size_t plan = static_cast<size_t>(e) * (N / BN) + n;
  const size_t row = plan * max_nnz;
  bsp::warp_tile<T, BN, kRows, kInt8>(
      x, kInt8 ? nullptr : w + static_cast<size_t>(e) * K * N, tiles,
      indices + row, kInt8 ? slots + row : nullptr,
      kInt8 ? scales + row : nullptr, __ldg(counts + plan), y, m0,
      m0 + kRows, K, N, col0, sub, smem + warp * L::kWarp);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kMaxWarps * 32)
ragged_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const int* __restrict__ counts,
              const int* __restrict__ indices,
              const int* __restrict__ tile_expert, T* __restrict__ y, int M,
              int K, int N, int E, int max_nnz) {
  ragged_run<T, BN, false>(x, w, nullptr, counts, indices, nullptr, nullptr,
                           tile_expert, y, M, K, N, E, max_nnz);
}

template <typename T, int BN>
__global__ void __launch_bounds__(kMaxWarps * 32)
quant_ragged_kernel(const T* __restrict__ x,
                    const int8_t* __restrict__ tiles,
                    const int* __restrict__ counts,
                    const int* __restrict__ indices,
                    const int* __restrict__ slots,
                    const float* __restrict__ scales,
                    const int* __restrict__ tile_expert, T* __restrict__ y,
                    int M, int K, int N, int E, int max_nnz) {
  ragged_run<T, BN, true>(x, nullptr, tiles, counts, indices, slots, scales,
                          tile_expert, y, M, K, N, E, max_nnz);
}

// The pointers of one launch: w (dense) or tiles / slots / scales (int8,
// tiles != nullptr), and the plan with its occupancy map (`map`: work
// for the grouped kernel, tile_expert for the ragged one).
struct Args {
  const void* x;
  const void* w;
  const void* tiles;
  const void* slots;
  const void* scales;
  const int* counts;
  const int* indices;
  const int* map;
  void* y;
};

// The tile choice: kernel 1's rule over a panel of block_m rows, and
// for bf16 at 64-row tiles the shared-x block (kGroup warps, the fixed
// part of its shared memory). tile_config in
// kernels/grouped_block_sparse/kernel.py mirrors it.
Config choose(int block_m, bool bf16, bool int8) {
  Config c = bsp::choose(block_m, bf16, int8);
  if (bf16 && c.m_tile == 64) {
    c.stages = SharedX<false>::kS;
    c.warps = kGroup;
    c.smem = int8 ? SharedX<true>::kFixed : SharedX<false>::kFixed;
  }
  return c;
}

// One warp a (slice, M-tile), `c.warps` warps a block.
template <typename T, int BN, int BM>
int launch_warps(const Args& a, const Config& c, int E, int M, int K, int N,
                 int max_nnz, int block_m, cudaStream_t st) {
  // the attribute once per (T, BN, BM), at the largest block either
  // kernel may take
  static const cudaError_t attr = [] {
    constexpr int dense = bsp::Smem<T, BM, false>::kWarp;
    constexpr int quant = bsp::Smem<T, BM, true>::kWarp;
    constexpr int bytes = kMaxWarps * (dense > quant ? dense : quant);
    cudaError_t e = cudaFuncSetAttribute(
        grouped_kernel<T, BN, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(quant_grouped_kernel<T, BN, BM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int CW = bsp::col_width(!std::is_same<T, float>::value, BM);
  const long warps_total =
      static_cast<long>(E) * (N / CW) * Tiles(M, block_m, BM).n_mt;
  const dim3 grid(static_cast<unsigned>((warps_total + c.warps - 1) /
                                        c.warps));
  const dim3 block(32 * c.warps);
  const T* xp = static_cast<const T*>(a.x);
  T* yp = static_cast<T*>(a.y);
  if (a.tiles == nullptr) {
    grouped_kernel<T, BN, BM><<<grid, block, c.smem, st>>>(
        xp, static_cast<const T*>(a.w), a.counts, a.indices, a.map, yp, E,
        M, K, N, max_nnz, block_m);
  } else {
    quant_grouped_kernel<T, BN, BM><<<grid, block, c.smem, st>>>(
        xp, static_cast<const int8_t*>(a.tiles), a.counts, a.indices,
        static_cast<const int*>(a.slots), static_cast<const float*>(a.scales),
        a.map, yp, E, M, K, N, max_nnz, block_m);
  }
  return static_cast<int>(cudaGetLastError());
}

// One block a (group of kGroup slices, M-tile): bf16 at 64-row tiles.
template <int BN>
int launch_shared_x(const Args& a, int E, int M, int K, int N, int max_nnz,
                    int block_m, cudaStream_t st) {
  using T = __nv_bfloat16;
  constexpr int kMax = 232448;             // the H100's 227 KB a block
  // the attribute once per BN, at the most a block may take (the
  // merge's share grows with K)
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_shared_x_kernel<BN, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMax);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(grouped_shared_x_kernel<BN, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMax);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool int8 = a.tiles != nullptr;
  const int smem = shared_x_bytes(int8, K, BN);
  if (smem > kMax || K / BN > 0xffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const long blocks = static_cast<long>(E) *
                      ((N / 16 + kGroup - 1) / kGroup) *
                      Tiles(M, block_m, 64).n_mt;
  const T* xp = static_cast<const T*>(a.x);
  T* yp = static_cast<T*>(a.y);
  if (!int8)
    grouped_shared_x_kernel<BN, false>
        <<<static_cast<unsigned>(blocks), kGroup * 32, smem, st>>>(
            xp, static_cast<const T*>(a.w), nullptr, a.counts, a.indices,
            nullptr, nullptr, a.map, yp, M, K, N, max_nnz, block_m);
  else
    grouped_shared_x_kernel<BN, true>
        <<<static_cast<unsigned>(blocks), kGroup * 32, smem, st>>>(
            xp, nullptr, static_cast<const int8_t*>(a.tiles), a.counts,
            a.indices, static_cast<const int*>(a.slots),
            static_cast<const float*>(a.scales), a.map, yp, M, K, N,
            max_nnz, block_m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int launch_grouped_block(const Args& a, int E, int M, int K, int N,
                         int max_nnz, int block_m, cudaStream_t st) {
  const Config c =
      choose(block_m, !std::is_same<T, float>::value, a.tiles != nullptr);
  if (c.m_tile == 16)
    return launch_warps<T, BN, 16>(a, c, E, M, K, N, max_nnz, block_m, st);
  if constexpr (std::is_same<T, float>::value)
    return launch_warps<T, BN, 64>(a, c, E, M, K, N, max_nnz, block_m, st);
  else
    return launch_shared_x<BN>(a, E, M, K, N, max_nnz, block_m, st);
}

// One warp a (tile, slice) at 16-row tiles, bsp::choose's warps a block
// (two in f32, four in bf16).
template <typename T, int BN>
int launch_ragged(const Args& a, int E, int M, int K, int N, int max_nnz,
                  cudaStream_t st) {
  // the attribute once per (T, BN), at the largest block either kernel
  // may take (kernel 9's bf16 rings need 52,416 bytes, above the default
  // 48 KB)
  static const cudaError_t attr = [] {
    constexpr int dense = bsp::Smem<T, kRows, false>::kWarp;
    constexpr int quant = bsp::Smem<T, kRows, true>::kWarp;
    constexpr int bytes = kMaxWarps * (dense > quant ? dense : quant);
    cudaError_t e = cudaFuncSetAttribute(
        ragged_kernel<T, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(quant_ragged_kernel<T, BN>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    return e;
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const bool int8 = a.tiles != nullptr;
  const Config c =
      bsp::choose(kRows, !std::is_same<T, float>::value, int8);
  constexpr int CW = bsp::col_width(!std::is_same<T, float>::value, kRows);
  const long warps_total = static_cast<long>(M / kRows) * (N / CW);
  const dim3 grid(static_cast<unsigned>((warps_total + c.warps - 1) /
                                        c.warps));
  const dim3 block(32 * c.warps);
  const T* xp = static_cast<const T*>(a.x);
  T* yp = static_cast<T*>(a.y);
  if (!int8)
    ragged_kernel<T, BN><<<grid, block, c.smem, st>>>(
        xp, static_cast<const T*>(a.w), a.counts, a.indices, a.map, yp, M,
        K, N, E, max_nnz);
  else
    quant_ragged_kernel<T, BN><<<grid, block, c.smem, st>>>(
        xp, static_cast<const int8_t*>(a.tiles), a.counts, a.indices,
        static_cast<const int*>(a.slots), static_cast<const float*>(a.scales),
        a.map, yp, M, K, N, E, max_nnz);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BN>
int launch_block(const Args& a, bool ragged, int E, int M, int K, int N,
                 int max_nnz, int block_m, cudaStream_t st) {
  if (ragged) return launch_ragged<T, BN>(a, E, M, K, N, max_nnz, st);
  return launch_grouped_block<T, BN>(a, E, M, K, N, max_nnz, block_m, st);
}

template <typename T>
int launch(const Args& a, bool ragged, int E, int M, int K, int N,
           int max_nnz, int block, int block_m, void* stream) {
  if (M <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (ragged ? M % kRows != 0
             : (block_m <= 0 || M % block_m || block_m % kRows))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (block) {
    case 16:
      return launch_block<T, 16>(a, ragged, E, M, K, N, max_nnz, block_m,
                                 st);
    case 32:
      return launch_block<T, 32>(a, ragged, E, M, K, N, max_nnz, block_m,
                                 st);
    case 64:
      return launch_block<T, 64>(a, ragged, E, M, K, N, max_nnz, block_m,
                                 st);
    case 128:
      return launch_block<T, 128>(a, ragged, E, M, K, N, max_nnz, block_m,
                                  st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int grouped(const void* x, const void* w, const void* tiles,
            const void* slots, const void* scales, const void* counts,
            const void* indices, const void* work, void* y, int E, int M,
            int K, int N, int max_nnz, int block, int block_m,
            void* stream) {
  const Args a{x, w, tiles, slots, scales, static_cast<const int*>(counts),
               static_cast<const int*>(indices),
               static_cast<const int*>(work), y};
  return launch<T>(a, false, E, M, K, N, max_nnz, block, block_m, stream);
}

template <typename T>
int ragged(const void* x, const void* w, const void* tiles,
           const void* slots, const void* scales, const void* counts,
           const void* indices, const void* tile_expert, void* y, int M,
           int K, int N, int E, int max_nnz, int block, void* stream) {
  const Args a{x, w, tiles, slots, scales, static_cast<const int*>(counts),
               static_cast<const int*>(indices),
               static_cast<const int*>(tile_expert), y};
  return launch<T>(a, true, E, M, K, N, max_nnz, block, kRows, stream);
}

}  // namespace

extern "C" {

// Each entry point launches on `stream` and returns cudaGetLastError()
// right after the launch (0 on success). The caller checks shapes:
// K % block == 0, N % block == 0, max_nnz >= 1; grouped: M % block_m == 0
// and block_m % 16 == 0; ragged: M % 16 == 0; x, w and tiles on 16 bytes;
// int8: every slot below the number of stored tiles.
int grouped_block_sparse_matmul_f32(const void* x, const void* w,
                                    const void* counts, const void* indices,
                                    const void* work, void* y, int E, int M,
                                    int K, int N, int max_nnz, int block,
                                    int block_m, void* stream) {
  return grouped<float>(x, w, nullptr, nullptr, nullptr, counts, indices,
                        work, y, E, M, K, N, max_nnz, block, block_m,
                        stream);
}

int grouped_block_sparse_matmul_bf16(const void* x, const void* w,
                                     const void* counts, const void* indices,
                                     const void* work, void* y, int E, int M,
                                     int K, int N, int max_nnz, int block,
                                     int block_m, void* stream) {
  return grouped<__nv_bfloat16>(x, w, nullptr, nullptr, nullptr, counts,
                                indices, work, y, E, M, K, N, max_nnz, block,
                                block_m, stream);
}

int ragged_block_sparse_matmul_f32(const void* x, const void* w,
                                   const void* counts, const void* indices,
                                   const void* tile_expert, void* y, int M,
                                   int K, int N, int E, int max_nnz,
                                   int block, void* stream) {
  return ragged<float>(x, w, nullptr, nullptr, nullptr, counts, indices,
                       tile_expert, y, M, K, N, E, max_nnz, block, stream);
}

int ragged_block_sparse_matmul_bf16(const void* x, const void* w,
                                    const void* counts, const void* indices,
                                    const void* tile_expert, void* y, int M,
                                    int K, int N, int E, int max_nnz,
                                    int block, void* stream) {
  return ragged<__nv_bfloat16>(x, w, nullptr, nullptr, nullptr, counts,
                               indices, tile_expert, y, M, K, N, E, max_nnz,
                               block, stream);
}

int quant_grouped_block_sparse_matmul_f32(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* work, void* y, int E, int M, int K, int N, int max_nnz,
    int block, int block_m, void* stream) {
  return grouped<float>(x, nullptr, tiles, slots, scales, counts, indices,
                        work, y, E, M, K, N, max_nnz, block, block_m,
                        stream);
}

int quant_grouped_block_sparse_matmul_bf16(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* work, void* y, int E, int M, int K, int N, int max_nnz,
    int block, int block_m, void* stream) {
  return grouped<__nv_bfloat16>(x, nullptr, tiles, slots, scales, counts,
                                indices, work, y, E, M, K, N, max_nnz, block,
                                block_m, stream);
}

int quant_ragged_block_sparse_matmul_f32(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* tile_expert, void* y, int M, int K, int N, int E,
    int max_nnz, int block, void* stream) {
  return ragged<float>(x, nullptr, tiles, slots, scales, counts, indices,
                       tile_expert, y, M, K, N, E, max_nnz, block, stream);
}

int quant_ragged_block_sparse_matmul_bf16(
    const void* x, const void* tiles, const void* counts,
    const void* indices, const void* slots, const void* scales,
    const void* tile_expert, void* y, int M, int K, int N, int E,
    int max_nnz, int block, void* stream) {
  return ragged<__nv_bfloat16>(x, nullptr, tiles, slots, scales, counts,
                               indices, tile_expert, y, M, K, N, E, max_nnz,
                               block, stream);
}

// The tile a grouped launch takes for a panel of block_m rows (M only
// checked): out = {M-tile rows, ring stages, warps per thread block,
// 0 FFMA / 1 mma.sync, dynamic shared bytes per block}. Lets a caller
// hold the Python mirror (kernels/grouped_block_sparse/kernel.py::
// tile_config) to it.
int grouped_block_sparse_tile_config(int M, int block_m, int bf16, int int8,
                                     int* out) {
  if (block_m <= 0 || block_m % kRows || M % block_m)
    return static_cast<int>(cudaErrorInvalidValue);
  const Config c = choose(block_m, bf16 != 0, int8 != 0);
  out[0] = c.m_tile;
  out[1] = c.stages;
  out[2] = c.warps;
  out[3] = c.mma;
  out[4] = c.smem;
  return 0;
}

}  // extern "C"
