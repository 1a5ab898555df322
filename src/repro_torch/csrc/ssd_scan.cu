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
//    (one group), as 64x64 tiles of its lower block triangle, stored
//    transposed in the scratch `cb` (B, n_chunks, Qp, Qp): cb[j][i].
// 2. ssd_state_kernel: per (sequence, chunk, head, slice of PS columns of
//    P), S_c into the scratch `hs` (B, n_chunks, H, P, N), and the chunk's
//    decay exp(Lc_last) into `dec` (B, n_chunks, H).
// 3. ssd_pass_kernel: per (sequence, head), h_{c+1} = h_c * dec_c + S_c
//    from h0 (or zero), overwriting each S_c in `hs` with h_c, and writing
//    the final state in the cache's (B, H, P, N) layout.
// 4. ssd_out_kernel: per (sequence, chunk, head, slice), y from the scores
//    tiles of `cb` (decayed and masked: exp only where i >= j, since
//    exp(Lc_i - Lc_j) above the diagonal may overflow), xt, C and h_c.
// Each inner step reads one shared-memory operand as a float4 of four rows
// and the other as PS/16 contiguous columns. All in f32 with expf and
// plain FFMA (no TF32), every sum in the order of the single-block scan;
// the output is rounded once to xt's type.
//
// Layouts: xt, y (B, L, H, P) contiguous; da (B, L, H) f32 contiguous;
// Bm, Cm (B, L, N) with unit stride over N and the batch and position
// strides given (both are strided slices of the conv output, read in
// place); h0, h_out (B, H, P, N) f32 contiguous. Q <= 256, N <= 128, P a
// multiple of the slice width PS (16, 32 or 64).
//
// Bound on the H100: operations. At mamba2's 4096-token prefill (H 64,
// P 64, N 128, chunk 256) the TPU kernel's arithmetic is about 34 GFLOP
// against about 138 MB of inputs and outputs: 0.51 ms at the f32 FFMA
// peak against 0.04 ms at the memory rate. Forming C B^T once per chunk
// drops most of that arithmetic; the chunk states add (B, n_chunks, H,
// P, N) f32 of scratch (34 MB there), written, passed and read. What this
// design leaves: no tensor cores, and no overlap of a tile's loads with
// the previous tile's math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;              // chunk rows per tile
constexpr int kTS = kTile + 4;         // transposed-tile row: float4-aligned
constexpr int kMaxQ = 256;             // largest chunk
constexpr int kMaxN = 128;             // largest state width

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

// W contiguous floats from shared memory (16-byte aligned for W = 4).
template <int W>
__device__ __forceinline__ void load_row(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = p[0];
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

// Rows i0.. of the chunk starting at t0 of src (B or C, by stride),
// transposed into ct[n][row] (row stride kTS).
template <typename T>
__device__ __forceinline__ void load_rows_t(const T* __restrict__ src,
                                            float* ct, int t0, int i0,
                                            int L, int N, int Q,
                                            long long row) {
  for (int idx = threadIdx.x; idx < kTile * N; idx += kThreads) {
    const int rr = idx / N, n = idx % N;
    const int r = i0 + rr, t = t0 + r;
    ct[n * kTS + rr] = (r < Q && t < L) ? to_f32(src[t * row + n]) : 0.f;
  }
}

// Rows j0.. of xt's PS columns starting at x_base into xs[row][col].
template <typename T, int PS>
__device__ __forceinline__ void load_xt(const T* __restrict__ xt, float* xs,
                                        size_t x_base, size_t x_row, int t0,
                                        int j0, int L, int Q) {
  for (int idx = threadIdx.x; idx < kTile * PS; idx += kThreads) {
    const int rr = idx / PS, p = idx % PS;
    const int r = j0 + rr, t = t0 + r;
    xs[idx] = (r < Q && t < L)
                  ? to_f32(xt[x_base + static_cast<size_t>(t) * x_row + p])
                  : 0.f;
  }
}

// ------------------------------------------------------ 1. C B^T tiles

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_cb_kernel(const T* __restrict__ bm, const T* __restrict__ cm,
              float* __restrict__ cb, int L, int N, int Q, int Qp,
              long long bc_batch, long long bc_row) {
  extern __shared__ float smem[];
  const int NP = N + 1;                // padded row: conflict-free reads
  float* bs = smem;                    // (64, N + 1) B rows of tile jt
  float* cs = bs + kTile * NP;         // (64, N + 1) C rows of tile it
  int it = 0;
  while ((it + 1) * (it + 2) / 2 <= static_cast<int>(blockIdx.x)) ++it;
  const int jt = blockIdx.x - it * (it + 1) / 2;
  const int c = blockIdx.y, b = blockIdx.z;
  const int t0 = c * Q, i0 = it * kTile, j0 = jt * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const T* bmb = bm + b * bc_batch;
  const T* cmb = cm + b * bc_batch;
  for (int idx = tid; idx < kTile * N; idx += kThreads) {
    const int rr = idx / N, n = idx % N;
    const int rj = j0 + rr, tj = t0 + rj, ri = i0 + rr, ti = t0 + ri;
    bs[rr * NP + n] = (rj < Q && tj < L) ? to_f32(bmb[tj * bc_row + n])
                                         : 0.f;
    cs[rr * NP + n] = (ri < Q && ti < L) ? to_f32(cmb[ti * bc_row + n])
                                         : 0.f;
  }
  __syncthreads();
  float g[4][4];                       // g[r][q]: row j, column i
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) g[r][q] = 0.f;
#pragma unroll 4
  for (int n = 0; n < N; ++n) {
    float bv[4], cv[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) bv[r] = bs[(ty * 4 + r) * NP + n];
#pragma unroll
    for (int q = 0; q < 4; ++q) cv[q] = cs[(tx + 16 * q) * NP + n];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) g[r][q] = fmaf(cv[q], bv[r], g[r][q]);
  }
  float* out = cb + (static_cast<size_t>(b) * gridDim.y + c) * Qp * Qp;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      out[static_cast<size_t>(j0 + ty * 4 + r) * Qp + i0 + tx + 16 * q] =
          g[r][q];
}

// ------------------------------------------------------ 2. chunk states

size_t state_smem_floats(int N, int PS) {
  return 2 * kMaxQ                                 // Lc, exp(Lc_last - Lc)
         + static_cast<size_t>(N) * kTS            // B^T of one row tile
         + kTile * PS;                             // xt of that tile
}

template <typename T, int PS>
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const T* __restrict__ xt, const float* __restrict__ da,
                 const T* __restrict__ bm, float* __restrict__ hs,
                 float* __restrict__ dec, int L, int H, int P, int N, int Q,
                 int n_chunks, long long bc_batch, long long bc_row) {
  constexpr int ROWS_PER_PASS = kThreads / PS;   // state rows per pass
  constexpr int MAXE = kMaxN / ROWS_PER_PASS;    // state entries a thread
  extern __shared__ float smem[];
  float* lc = smem;                    // (kMaxQ) cumulative log-decay
  float* wend = lc + kMaxQ;            // exp(Lc_last - Lc_j)
  float* ct = wend + kMaxQ;            // (N, 68) B rows of tile i
  float* xs = ct + N * kTS;            // (64, PS) xt rows of tile i

  const int c = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * PS;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int sp = tid % PS;             // this thread's state column
  const int sn0 = tid / PS;            // its first state row
  const int t0 = c * Q;
  const size_t x_row = static_cast<size_t>(H) * P;
  const size_t x_base = static_cast<size_t>(b) * L * x_row
                        + static_cast<size_t>(h) * P + p0;
  const T* bmb = bm + b * bc_batch;

  chunk_cumsum(da, lc, b, h, t0, L, H, Q);
  __syncthreads();
  const float lc_last = lc[Q - 1];
  for (int r = tid; r < kMaxQ; r += kThreads) wend[r] = expf(lc_last - lc[r]);
  if (blockIdx.y == 0 && tid == 0)
    dec[(static_cast<size_t>(b) * n_chunks + c) * H + h] = expf(lc_last);

  float upd[MAXE];
#pragma unroll
  for (int k = 0; k < MAXE; ++k) upd[k] = 0.f;
  const int n_tiles = (Q + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    __syncthreads();                   // readers of ct and xs are done
    load_rows_t(bmb, ct, t0, i0, L, N, Q, bc_row);
    load_xt<T, PS>(xt, xs, x_base, x_row, t0, i0, L, Q);
    __syncthreads();
#pragma unroll 2
    for (int rr = 0; rr < kTile; rr += 4) {
      float xw[4];
#pragma unroll
      for (int a = 0; a < 4; ++a)
        xw[a] = xs[(rr + a) * PS + sp] * wend[i0 + rr + a];
#pragma unroll
      for (int k = 0; k < MAXE; ++k) {
        const int n = sn0 + k * ROWS_PER_PASS;
        if (n < N) {
          float bv[4];
          load_row<4>(ct + n * kTS + rr, bv);
#pragma unroll
          for (int a = 0; a < 4; ++a) upd[k] = fmaf(bv[a], xw[a], upd[k]);
        }
      }
    }
  }
  float* out = hs + ((static_cast<size_t>(b) * n_chunks + c) * H + h) * P * N;
#pragma unroll
  for (int k = 0; k < MAXE; ++k) {
    const int n = sn0 + k * ROWS_PER_PASS;
    if (n < N) out[static_cast<size_t>(p0 + sp) * N + n] = upd[k];
  }
}

// ------------------------------------------------------ 3. state pass

__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(const float* __restrict__ h0, float* __restrict__ hs,
                const float* __restrict__ dec, float* __restrict__ h_out,
                int H, int PN, int n_chunks) {
  const int h = blockIdx.x, b = blockIdx.y;
  const size_t step = static_cast<size_t>(H) * PN;    // one chunk's states
  const size_t base = (static_cast<size_t>(b) * n_chunks * H + h) * PN;
  const float* db = dec + static_cast<size_t>(b) * n_chunks * H + h;
  const size_t hb = (static_cast<size_t>(b) * H + h) * PN;
  for (int e = blockIdx.z * kThreads + threadIdx.x; e < PN;
       e += gridDim.z * kThreads) {
    float s = h0 ? h0[hb + e] : 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      float* at = hs + base + c * step + e;
      const float upd = *at;
      *at = s;                         // the state entering chunk c
      s = fmaf(s, db[static_cast<size_t>(c) * H], upd);
    }
    h_out[hb + e] = s;
  }
}

// ------------------------------------------------------ 4. outputs

size_t out_smem_floats(int N, int PS) {
  return static_cast<size_t>(N) * PS              // the state entering c
         + 2 * kMaxQ                               // Lc, exp(Lc)
         + static_cast<size_t>(N) * kTS            // C^T of tile i
         + kTile * PS                              // xt tile
         + kTile * kTS;                            // masked scores, transposed
}

template <typename T, int PS>
__global__ void __launch_bounds__(kThreads)
ssd_out_kernel(const T* __restrict__ xt, const float* __restrict__ da,
               const T* __restrict__ cm, const float* __restrict__ cb,
               const float* __restrict__ hs, T* __restrict__ y, int L, int H,
               int P, int N, int Q, int Qp, int n_chunks, long long bc_batch,
               long long bc_row) {
  constexpr int DJ = PS / 16;          // contiguous output columns a thread
  extern __shared__ float smem[];
  float* st = smem;                    // (N, PS) state slice entering c
  float* lc = st + N * PS;             // (kMaxQ) cumulative log-decay
  float* elc = lc + kMaxQ;             // exp(Lc_i)
  float* ct = elc + kMaxQ;             // (N, 68) C rows of tile i
  float* xs = ct + N * kTS;            // (64, PS) xt rows of tile j
  float* gt = xs + kTile * PS;         // (64, 68) scores: gt[j][i]

  const int c = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * PS;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int t0 = c * Q;
  const size_t x_row = static_cast<size_t>(H) * P;
  const size_t x_base = static_cast<size_t>(b) * L * x_row
                        + static_cast<size_t>(h) * P + p0;
  const T* cmb = cm + b * bc_batch;
  const float* cbc = cb + (static_cast<size_t>(b) * n_chunks + c) * Qp * Qp;
  const float* hc = hs + ((static_cast<size_t>(b) * n_chunks + c) * H + h)
                             * P * N;

  chunk_cumsum(da, lc, b, h, t0, L, H, Q);
  for (int e = tid; e < N * PS; e += kThreads) {
    const int n = e / PS, p = e % PS;
    st[e] = hc[static_cast<size_t>(p0 + p) * N + n];
  }
  __syncthreads();
  for (int r = tid; r < kMaxQ; r += kThreads) elc[r] = expf(lc[r]);

  const int n_tiles = (Q + kTile - 1) / kTile;
  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    float acc[4][DJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < DJ; ++q) acc[r][q] = 0.f;

    for (int jt = 0; jt <= it; ++jt) {
      const int j0 = jt * kTile;
      __syncthreads();                 // readers of xs and gt are done
      load_xt<T, PS>(xt, xs, x_base, x_row, t0, j0, L, Q);
      for (int idx = tid; idx < kTile * kTile; idx += kThreads) {
        const int jj = idx / kTile, ii = idx % kTile;
        const int i = i0 + ii, j = j0 + jj;
        gt[jj * kTS + ii] =
            i >= j ? cbc[static_cast<size_t>(j) * Qp + i]
                         * expf(lc[i] - lc[j])
                   : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < kTile; ++jj) {
        float pv[4], xv[DJ];
        load_row<4>(gt + jj * kTS + ty * 4, pv);
        load_row<DJ>(xs + jj * PS + tx * DJ, xv);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int q = 0; q < DJ; ++q) acc[r][q] = fmaf(pv[r], xv[q], acc[r][q]);
      }
    }

    __syncthreads();                   // readers of ct are done
    load_rows_t(cmb, ct, t0, i0, L, N, Q, bc_row);
    __syncthreads();
    float inter[4][DJ];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < DJ; ++q) inter[r][q] = 0.f;
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      float cv[4], sv[DJ];
      load_row<4>(ct + n * kTS + ty * 4, cv);
      load_row<DJ>(st + n * PS + tx * DJ, sv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < DJ; ++q) inter[r][q] = fmaf(cv[r], sv[q], inter[r][q]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty * 4 + r, t = t0 + i;
      if (i < Q && t < L) {
        T* yrow = y + x_base + static_cast<size_t>(t) * x_row + tx * DJ;
#pragma unroll
        for (int q = 0; q < DJ; ++q)
          yrow[q] = from_f32<T>(fmaf(elc[i], inter[r][q], acc[r][q]));
      }
    }
  }
}

template <typename K>
cudaError_t allow_smem(K kern, size_t floats) {
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(sizeof(float) * floats));
}

template <typename T, int PS>
int launch_ps(const void* xt_, const void* da_, const void* bm_,
              const void* cm_, void* cb_, void* hs_, void* dec_,
              const void* h0, void* y_, void* h_out, int B, int L, int H,
              int P, int N, int Q, long long bc_batch, long long bc_row,
              cudaStream_t stream) {
  const T* xt = static_cast<const T*>(xt_);
  const float* da = static_cast<const float*>(da_);
  const T* bm = static_cast<const T*>(bm_);
  const T* cm = static_cast<const T*>(cm_);
  float* cb = static_cast<float*>(cb_);
  float* hs = static_cast<float*>(hs_);
  float* dec = static_cast<float*>(dec_);
  const int n_chunks = (L + Q - 1) / Q;
  const int n_tiles = (Q + kTile - 1) / kTile;
  const int Qp = n_tiles * kTile;
  const size_t cb_smem = 2 * kTile * static_cast<size_t>(N + 1);
  const size_t st_smem = state_smem_floats(N, PS);
  const size_t out_smem = out_smem_floats(N, PS);
  cudaError_t err = allow_smem(ssd_cb_kernel<T>, cb_smem);
  if (err == cudaSuccess)
    err = allow_smem(ssd_state_kernel<T, PS>, st_smem);
  if (err == cudaSuccess) err = allow_smem(ssd_out_kernel<T, PS>, out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);

  ssd_cb_kernel<T><<<dim3(n_tiles * (n_tiles + 1) / 2, n_chunks, B),
                     kThreads, sizeof(float) * cb_smem, stream>>>(
      bm, cm, cb, L, N, Q, Qp, bc_batch, bc_row);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_chunks * H, P / PS, B);
  ssd_state_kernel<T, PS><<<grid, kThreads, sizeof(float) * st_smem,
                            stream>>>(
      xt, da, bm, hs, dec, L, H, P, N, Q, n_chunks, bc_batch, bc_row);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int PN = P * N;
  ssd_pass_kernel<<<dim3(H, B, (PN + kThreads - 1) / kThreads), kThreads, 0,
                    stream>>>(static_cast<const float*>(h0), hs, dec,
                              static_cast<float*>(h_out), H, PN, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssd_out_kernel<T, PS><<<grid, kThreads, sizeof(float) * out_smem,
                          stream>>>(
      xt, da, cm, cb, hs, static_cast<T*>(y_), L, H, P, N, Q, Qp, n_chunks,
      bc_batch, bc_row);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* xt, const void* da, const void* bm, const void* cm,
           void* cb, void* hs, void* dec, const void* h0, void* y,
           void* h_out, int B, int L, int H, int P, int N, int Q, int PS,
           long long bc_batch, long long bc_row, void* stream) {
  if (Q < 1 || Q > kMaxQ || N < 1 || N > kMaxN || P % PS)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (PS) {
    case 16:
      return launch_ps<T, 16>(xt, da, bm, cm, cb, hs, dec, h0, y, h_out, B,
                              L, H, P, N, Q, bc_batch, bc_row, st);
    case 32:
      return launch_ps<T, 32>(xt, da, bm, cm, cb, hs, dec, h0, y, h_out, B,
                              L, H, P, N, Q, bc_batch, bc_row, st);
    case 64:
      return launch_ps<T, 64>(xt, da, bm, cm, cb, hs, dec, h0, y, h_out, B,
                              L, H, P, N, Q, bc_batch, bc_row, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Each entry point launches the four kernels on `stream` and returns the
// CUDA error of the launches (0 on success). Scratch, f32, n_chunks =
// ceil(L / Q), Qp = 64 * ceil(Q / 64): cb of B * n_chunks * Qp * Qp
// floats, hs of B * n_chunks * H * P * N, dec of B * n_chunks * H. h0 may
// be null (a zero initial state). The caller checks shapes: 1 <= Q <= 256,
// 1 <= N <= 128, PS in {16, 32, 64} dividing P, B <= 65535,
// n_chunks * H < 2^31, n_chunks <= 65535.
int ssd_scan_f32(const void* xt, const void* da, const void* bm,
                 const void* cm, void* cb, void* hs, void* dec,
                 const void* h0, void* y, void* h_out, int B, int L, int H,
                 int P, int N, int Q, int PS, long long bc_batch,
                 long long bc_row, void* stream) {
  return launch<float>(xt, da, bm, cm, cb, hs, dec, h0, y, h_out, B, L, H,
                       P, N, Q, PS, bc_batch, bc_row, stream);
}

int ssd_scan_bf16(const void* xt, const void* da, const void* bm,
                  const void* cm, void* cb, void* hs, void* dec,
                  const void* h0, void* y, void* h_out, int B, int L, int H,
                  int P, int N, int Q, int PS, long long bc_batch,
                  long long bc_row, void* stream) {
  return launch<__nv_bfloat16>(xt, da, bm, cm, cb, hs, dec, h0, y, h_out, B,
                               L, H, P, N, Q, PS, bc_batch, bc_row, stream);
}

}  // extern "C"
