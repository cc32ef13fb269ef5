// Backward of the simple-lattice build for Hopper (sm_90a): the VJP
// (lm, am, symbols, t_end, dpx, dpy [, dnd]) -> (d_lm, d_am [, d_uni]).
//
// Replaces the Pallas TPU kernel fast_rnnt_tpu/ops/kernels/latbuild.py
// _build_bwd_kernel, both variants: parts=False (:290, pallas_call :687,
// via _build_bwd :623 with the save_d residual) and parts=True (pallas_call
// :920, via _build_parts_bwd :884).
//
// With dpx' = dpx zeroed at t == T and, regular, at t == t_end:
//   w[s, t]      = (dnd[s, t] - dpx'[s, t] [s < S] - dpy[s, t]) / D[s, t]
//   d_am[t, c]   = amp[t, c] sum_s w[s, t] lmp[s, c]
//                + sum_s [sym_s == c] dpx'[s, t] + [c == blank] sum_s dpy[s, t]
//   d_lm[s, c]   = lmp[s, c] sum_t w[s, t] amp[t, c]
//                + [c == sym_s] sum_t dpx'[s, t] + [c == blank] sum_t dpy[s, t]
// with amp = exp(am - amax), lmp = exp(lm - lmmax) (the maxes are
// stop-gradient, as in the JAX package) and dnd = 0 for the plain build.
// The smoothed build adds one row S+1 to both GEMMs: lmp row S+1 = uni and
//   w[S+1, t] = rd[t] = -sum_s dnd[s, t] / duni[t],
// so GEMM (A) yields the amp uni rd term of d_am with no extra code, and
// row S+1 of GEMM (B), before the lmp multiply, is the per-utterance d_uni
// partial sum_t rd[t] amp[t, c] (summed over b by the caller).  A symbol
// outside [0, C) contributes nothing, as in the forward.
//
// Design.  The Pallas kernel carries d_lm in VMEM across a sequential t
// grid; blocks here run in no order, so each output has exactly one owner
// block and no atomics are used (d_lm and d_uni are deterministic):
//   1. prep: one thread per (b, t), walking s.  It reads the residual D
//      that the training forward saved (S+1, B, T) and the cotangents once,
//      writes w (B, S+1(+1), T) (12 MB: a pre-pass, not formed while
//      staging, because both GEMMs read it and GEMM (B) reads it along t),
//      the column sums sum_s dpy (B, T), and one partial of the row sums
//      sum_t dpx', sum_t dpy per warp (B, P, S+1).
//   2. GEMM (A) d_am: block (64 t, 64 c, b), K = s.  amp is applied in the
//      epilogue from the forward's saved amax (B, T): no amax pass; the
//      one-hot term walks the symbols, the blank term adds the column sum.
//   3. GEMM (B) d_lm: block (64 c, 64 s, b), K = all of T in-block, with
//      exp(am - amax) taken as the am tile is staged; the epilogue sums the
//      P row-sum partials for the one-hot and blank terms.
// Both GEMMs use the forward's register-tiled fp32 step (common.cuh).
//
// What bounds it.  Two GEMMs of 2 B T (S+1) C = 3.0 GFLOP each, 6.1 GFLOP
// fp32 at the headline shape (B=30, T=1000, S=100, C=500): 90 us at the
// 67 TFLOP/s fp32 peak, against ~160 MB (am, D, dpx, dpy in; d_am out):
// 48 us at 3.35 TB/s.  The FMA rate bounds it, as in the forward.

#include <cuda_runtime.h>

#include "common.cuh"

using namespace frt;

namespace {

constexpr int kPrepThreads = 128;  // frames per prep block, one per thread
constexpr int kPrepWarps = kPrepThreads / 32;

__global__ void __launch_bounds__(kPrepThreads)
latbuild_bwd_prep_kernel(const float* __restrict__ d, const float* __restrict__ duni,
                         const float* __restrict__ dpx, const float* __restrict__ dpy,
                         const float* __restrict__ dnd, const int* __restrict__ te_arr, int B,
                         int S, int T, int modified, float* __restrict__ w,
                         float* __restrict__ colsum, float* __restrict__ rsx,
                         float* __restrict__ rsy) {
  const int b = blockIdx.y, t = blockIdx.x * kPrepThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int S1 = S + 1, S1x = S1 + (dnd != nullptr);
  const int T1 = modified ? T : T + 1;
  const int P = gridDim.x * kPrepWarps;
  const int part = blockIdx.x * kPrepWarps + (threadIdx.x >> 5);
  const bool live = t < T;
  const bool px_live = live && (modified || t != te_arr[b]);
  float cs = 0.f, ndsum = 0.f;
  for (int s = 0; s < S1; ++s) {
    const size_t o = ((size_t)s * B + b) * T + t;
    float dx = 0.f, dy = 0.f, dn = 0.f;
    if (live) {
      dy = dpy[o];
      if (s < S && px_live) dx = dpx[((size_t)s * B + b) * T1 + t];
      if (dnd != nullptr) dn = dnd[o];
      w[((size_t)b * S1x + s) * T + t] = (dn - dx - dy) / d[o];
      cs += dy;
      ndsum += dn;
    }
    const float rx = warp_sum(dx), ry = warp_sum(dy);
    if (lane == 0) {
      rsx[((size_t)b * P + part) * S1 + s] = rx;
      rsy[((size_t)b * P + part) * S1 + s] = ry;
    }
  }
  if (live) {
    colsum[(size_t)b * T + t] = cs;
    if (dnd != nullptr) w[((size_t)b * S1x + S1) * T + t] = -ndsum / duni[(size_t)b * T + t];
  }
}

// d_am: rows t, columns c, K = the S1x rows of w and lmp.
__global__ void __launch_bounds__(kGemmThreads)
latbuild_bwd_am_kernel(const float* __restrict__ lmp, const int* __restrict__ sym,
                       const int* __restrict__ te_arr, const float* __restrict__ am,
                       const float* __restrict__ amax, const float* __restrict__ w,
                       const float* __restrict__ colsum, const float* __restrict__ dpx, int B,
                       int S, int S1x, int T, int C, int blank, int modified,
                       float* __restrict__ d_am) {
  __shared__ __align__(16) GemmTileA As;  // w tile, [s][t]
  __shared__ __align__(16) GemmTileB Bs;  // lmp tile, [s][c]
  const int t0 = blockIdx.x * kGemmM, c0 = blockIdx.y * kGemmN, b = blockIdx.z;
  const int tid = threadIdx.x;
  const float* w_b = w + (size_t)b * S1x * T;
  const float* lmp_b = lmp + (size_t)b * S1x * C;

  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < S1x; k0 += kGemmK) {
    // consecutive threads read consecutive t (w) and consecutive c (lmp)
    for (int i = tid; i < kGemmK * kGemmM; i += kGemmThreads) {
      const int k = i / kGemmM, r = i % kGemmM;
      const int s = k0 + k, t = t0 + r, c = c0 + r;
      As[k][r] = (s < S1x && t < T) ? w_b[(size_t)s * T + t] : 0.f;
      Bs[k][r] = (s < S1x && c < C) ? lmp_b[(size_t)s * C + c] : 0.f;
    }
    __syncthreads();
    gemm_tile_step(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const int T1 = modified ? T : T + 1;
  const int te = te_arr[b];
  const int cb = c0 + tx * 4;  // this thread's first column
  // normalizer path and blank column
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T) break;
    const float* row = am + ((size_t)b * T + t) * C;
    const float amx = amax[(size_t)b * T + t];
    const float cs = colsum[(size_t)b * T + t];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + j;
      if (c >= C) break;
      acc[i][j] = expf(row[c] - amx) * acc[i][j] + (c == blank ? cs : 0.f);
    }
  }
  // px one-hot gather path: the symbols that fall in this thread's columns
  for (int s = 0; s < S; ++s) {
    const int dc = sym[(size_t)b * S + s] - cb;
    if (dc < 0 || dc >= 4 || cb + dc >= C) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= T || (!modified && t == te)) continue;
      const float g = dpx[((size_t)s * B + b) * T1 + t];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (dc == j) acc[i][j] += g;
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty * 4 + i;
    if (t >= T) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + j;
      if (c >= C) break;
      d_am[((size_t)b * T + t) * C + c] = acc[i][j];
    }
  }
}

// d_lm (and the d_uni partial): rows s, columns c, K = all T frames.
__global__ void __launch_bounds__(kGemmThreads)
latbuild_bwd_lm_kernel(const float* __restrict__ lmp, const int* __restrict__ sym,
                       const float* __restrict__ am, const float* __restrict__ amax,
                       const float* __restrict__ w, const float* __restrict__ rsx,
                       const float* __restrict__ rsy, int P, int S, int S1x, int T, int C,
                       int blank, float* __restrict__ d_lm, float* __restrict__ duni_part) {
  __shared__ __align__(16) GemmTileA As;  // w tile, [t][s]
  __shared__ __align__(16) GemmTileB Bs;  // exp(am - amax) tile, [t][c]
  const int c0 = blockIdx.x * kGemmN, s0 = blockIdx.y * kGemmM, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int S1 = S + 1;
  const float* w_b = w + (size_t)b * S1x * T;
  const float* am_b = am + (size_t)b * T * C;
  const float* amax_b = amax + (size_t)b * T;

  const int tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < T; k0 += kGemmK) {
    for (int i = tid; i < kGemmM * kGemmK; i += kGemmThreads) {
      // w: 16 consecutive t of one row s; am: consecutive c of one frame
      const int r = i / kGemmK, k = i % kGemmK;
      const int s = s0 + r, t = k0 + k;
      As[k][r] = (s < S1x && t < T) ? w_b[(size_t)s * T + t] : 0.f;
      const int kk = i / kGemmN, n = i % kGemmN;
      const int tt = k0 + kk, c = c0 + n;
      Bs[kk][n] = (tt < T && c < C) ? expf(am_b[(size_t)tt * C + c] - amax_b[tt]) : 0.f;
    }
    __syncthreads();
    gemm_tile_step(As, Bs, acc, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= S1x) break;
    if (s == S1) {  // the smoothed build's unigram row: the d_uni partial
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx * 4 + j;
        if (c < C) duni_part[(size_t)b * C + c] = acc[i][j];
      }
      continue;
    }
    const int sy = s < S ? sym[(size_t)b * S + s] : -1;
    const int cb = c0 + tx * 4;
    const bool want_x = sy >= cb && sy < cb + 4 && sy < C;
    const bool want_y = blank >= cb && blank < cb + 4;
    float gx = 0.f, gy = 0.f;  // sum over t of dpx' and dpy on row s
    for (int p = 0; p < P && (want_x || want_y); ++p) {
      gx += rsx[((size_t)b * P + p) * S1 + s];
      gy += rsy[((size_t)b * P + p) * S1 + s];
    }
    const float* lrow = lmp + ((size_t)b * S1x + s) * C;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cb + j;
      if (c >= C) break;
      float v = lrow[c] * acc[i][j];
      if (c == sy) v += gx;
      if (c == blank) v += gy;
      d_lm[((size_t)b * S1 + s) * C + c] = v;
    }
  }
}

}  // namespace

// lmp (B, S1x, C) f32 with S1x = S+1, or S+2 for the smoothed build (row
// S+1 = uni); symbols (B, S) and te (B,) int32 (te = -1: no t_end column);
// am (B, T, C); the forward's residuals amax (B, T), d (S+1, B, T) and,
// smoothed, duni (B, T); cotangents dpx (S, B, T or T+1), dpy (S+1, B, T)
// and, smoothed, dnd (S+1, B, T) (NULL for the plain build).
// Scratch: w (B, S1x, T), colsum (B, T), rsx and rsy (B, P, S+1) with
// P = 4 * ceil(T / 128).  Out: d_am (B, T, C), d_lm (B, S+1, C) and,
// smoothed, duni_part (B, C).  T >= 1.
extern "C" int frt_latbuild_bwd(const void* lmp, const void* sym, const void* te,
                                const void* am, const void* amax, const void* d,
                                const void* duni, const void* dpx, const void* dpy,
                                const void* dnd, int B, int S, int T, int C, int blank,
                                int modified, void* w, void* colsum, void* rsx, void* rsy,
                                void* d_am, void* d_lm, void* duni_part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S1x = S + 1 + (dnd != nullptr);
  const int prep_tiles = (T + kPrepThreads - 1) / kPrepThreads;
  const int P = prep_tiles * kPrepWarps;
  latbuild_bwd_prep_kernel<<<dim3((unsigned)prep_tiles, (unsigned)B), kPrepThreads, 0, st>>>(
      static_cast<const float*>(d), static_cast<const float*>(duni),
      static_cast<const float*>(dpx), static_cast<const float*>(dpy),
      static_cast<const float*>(dnd), static_cast<const int*>(te), B, S, T, modified,
      static_cast<float*>(w), static_cast<float*>(colsum), static_cast<float*>(rsx),
      static_cast<float*>(rsy));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned c_tiles = (unsigned)((C + kGemmN - 1) / kGemmN);
  latbuild_bwd_am_kernel<<<dim3((unsigned)((T + kGemmM - 1) / kGemmM), c_tiles, (unsigned)B),
                           kGemmThreads, 0, st>>>(
      static_cast<const float*>(lmp), static_cast<const int*>(sym),
      static_cast<const int*>(te), static_cast<const float*>(am),
      static_cast<const float*>(amax), static_cast<const float*>(w),
      static_cast<const float*>(colsum), static_cast<const float*>(dpx), B, S, S1x, T, C,
      blank, modified, static_cast<float*>(d_am));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  latbuild_bwd_lm_kernel<<<dim3(c_tiles, (unsigned)((S1x + kGemmM - 1) / kGemmM), (unsigned)B),
                           kGemmThreads, 0, st>>>(
      static_cast<const float*>(lmp), static_cast<const int*>(sym),
      static_cast<const float*>(am), static_cast<const float*>(amax),
      static_cast<const float*>(w), static_cast<const float*>(rsx),
      static_cast<const float*>(rsy), P, S, S1x, T, C, blank, static_cast<float*>(d_lm),
      static_cast<float*>(duni_part));
  return (int)cudaGetLastError();
}
