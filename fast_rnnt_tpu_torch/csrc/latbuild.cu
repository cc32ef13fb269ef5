// Simple-lattice build for Hopper (sm_90a): (lm parts, am, symbols) ->
// s-major (px, py) rows, and for the smoothed lattice the third output
// normd; when a gradient is needed, also the residuals of the backward.
//
// Replaces the Pallas TPU kernel fast_rnnt_tpu/ops/kernels/latbuild.py
// _build_fwd_kernel, both variants: parts=False (:207, pallas_call :587,
// entry lattice_rows_fused :713) and parts=True (pallas_call :836, entry
// lattice_rows_fused_smoothed :968), with its save_d residual (:269).  The
// lm side (lmp = exp(lm - lmmax), the per-(b, s) gathers pxlm and pylm, the
// unigram uni) is small plain-torch work done by the caller, as the Pallas
// entry leaves it to XLA.
//
// For each (utterance b, frame t):
//   amax    = max_c am[t, c]
//   D[s, t] = sum_c lmp[s, c] * exp(am[t, c] - amax) + tiny
//   lognorm = log D + lmmax[s]
//   px[s, t] = (am[t, sym_s] - amax) + pxlm[s] - lognorm   (s < S)
//   py[s, t] = (am[t, blank] - amax) + pylm[s] - lognorm
// regular: px[:, t] = -inf at t == T (the appended column) and t == t_end.
// smoothed (uni given):
//   duni[t]   = sum_c uni[c] * exp(am[t, c] - amax)
//   normd[s, t] = lognorm - log duni        (= norm - amonly: amax cancels)
// residuals (training only, pointers non-null): D (S+1, B, T), amax (B, T)
// and, smoothed, duni (B, T); the forward-only path writes none of them.
//
// Design.  D is, per utterance, an (S+1) x T x C product of two
// c-contiguous operands, written here as a register-tiled fp32 GEMM
// (common.cuh gemm_tile_step): one block per (64 frames, 64 rows s,
// utterance), 256 threads, each holding a 4 x 4 tile of accumulators.  The
// block first takes amax for its 64 frames (one warp per frame) and, when
// smoothed, duni in a second pass over the same (L1/L2-resident) rows, so
// normd needs no other block's rows.  Then it walks c in steps of 16,
// staging the lmp tile and the exp(am - amax) tile in shared memory (the
// exp is taken as the am tile is staged, so exp(am - amax) never goes to
// device memory).  The epilogue takes the log, and the symbol and blank
// gathers read am[t, c] straight from global memory (L2-resident: the
// block has just read those rows).
//
// What bounds it.  2 B (S+1) T C = 3.0 GFLOP fp32 at the headline shape
// (B=30, T=1000, S=100, C=500) against ~84 MB of traffic (am in, px and py
// out; +12 MB for D in training): 45 us at the 67 TFLOP/s fp32 peak, 25 us
// at 3.35 TB/s, so the FMA rate bounds it, and the 4 x 4 register tile (16
// FMAs per 2 shared loads) is what keeps the FMA pipes fed.  am is read
// twice (amax pass and tile loads) and the s dimension (101 rows) pads to
// two 64-row tiles: larger tiles, cp.async double buffering, or 3xTF32
// tensor-core products are later work.

#include <cuda_runtime.h>

#include <cfloat>

#include "common.cuh"

using namespace frt;

namespace {

__global__ void __launch_bounds__(kGemmThreads)
latbuild_fwd_kernel(const float* __restrict__ lmp, const float* __restrict__ pxlm,
                    const float* __restrict__ pylm, const float* __restrict__ lmmax,
                    const int* __restrict__ sym, const int* __restrict__ te_arr,
                    const float* __restrict__ am, const float* __restrict__ uni, int B, int S,
                    int T, int C, int blank, int modified, float* __restrict__ px,
                    float* __restrict__ py, float* __restrict__ nd, float* __restrict__ d_out,
                    float* __restrict__ amax_out, float* __restrict__ duni_out) {
  __shared__ __align__(16) GemmTileA As;  // lmp tile, [c][s]
  __shared__ __align__(16) GemmTileB Bs;  // exp(am - amax) tile, [c][t]
  __shared__ float amax_s[kGemmN];
  __shared__ float lduni_s[kGemmN];  // log duni (smoothed only)
  const int t0 = blockIdx.x * kGemmN, s0 = blockIdx.y * kGemmM, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int S1 = S + 1;
  const int T1 = modified ? T : T + 1;
  const float* am_b = am + (size_t)b * T * C;
  const float* lmp_b = lmp + (size_t)b * S1 * C;
  // the residuals (B, T) are written once, by the first s tile
  const bool row_owner = blockIdx.y == 0;

  // amax (and duni) of the block's frames, one warp per frame
  for (int n = w; n < kGemmN; n += kGemmThreads / 32) {
    const int t = t0 + n;
    float m = -FLT_MAX;
    if (t < T)
      for (int c = lane; c < C; c += 32) m = fmaxf(m, am_b[(size_t)t * C + c]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) amax_s[n] = m;
    if (uni != nullptr) {
      float u = 0.f;
      if (t < T)
        for (int c = lane; c < C; c += 32) u = fmaf(uni[c], expf(am_b[(size_t)t * C + c] - m), u);
      u = warp_sum(u);
      if (lane == 0) {
        lduni_s[n] = logf(u);
        if (duni_out != nullptr && row_owner && t < T) duni_out[(size_t)b * T + t] = u;
      }
    }
    if (lane == 0 && amax_out != nullptr && row_owner && t < T) amax_out[(size_t)b * T + t] = m;
  }
  __syncthreads();

  const int tx = tid & 15, ty = tid >> 4;  // 16 x 16 threads, 4 x 4 outputs each
  float acc[4][4] = {};
  for (int k0 = 0; k0 < C; k0 += kGemmK) {
    // stage kGemmM x kGemmK of lmp and kGemmN x kGemmK of exp(am - amax);
    // consecutive threads read consecutive c
    for (int i = tid; i < kGemmM * kGemmK; i += kGemmThreads) {
      const int r = i / kGemmK, k = i % kGemmK;
      const int s = s0 + r, c = k0 + k;
      As[k][r] = (s < S1 && c < C) ? lmp_b[(size_t)s * C + c] : 0.f;
      const int t = t0 + r;
      Bs[k][r] = (t < T && c < C) ? expf(am_b[(size_t)t * C + c] - amax_s[r]) : 0.f;
    }
    __syncthreads();
    gemm_tile_step(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const int te = te_arr[b];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = s0 + ty * 4 + i;
    if (s >= S1) break;
    const float lmx = lmmax[(size_t)b * S1 + s];
    const float pyl = pylm[(size_t)b * S1 + s];
    const bool has_px = s < S;
    const int sy = has_px ? sym[(size_t)b * S + s] : 0;
    // a symbol outside [0, C) reads am = 0, as the JAX package's one-hot
    // gather does (and never reads outside the row)
    const bool sy_ok = sy >= 0 && sy < C;
    const float pxl = has_px ? pxlm[(size_t)b * S + s] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx * 4 + j, t = t0 + n;
      if (t >= T) break;
      const float dv = acc[i][j] + FLT_MIN;
      const float lognorm = logf(dv) + lmx;
      const float* row = am_b + (size_t)t * C;
      const size_t o = ((size_t)s * B + b) * T + t;
      py[o] = (row[blank] - amax_s[n]) + pyl - lognorm;
      if (nd != nullptr) nd[o] = lognorm - lduni_s[n];
      if (d_out != nullptr) d_out[o] = dv;
      if (has_px) {
        float v = ((sy_ok ? row[sy] : 0.f) - amax_s[n]) + pxl - lognorm;
        if (!modified && t == te) v = kNegInf;
        px[((size_t)s * B + b) * T1 + t] = v;
      }
    }
  }
  // regular: the appended column t = T is -inf, written by the last t tile
  if (!modified && blockIdx.x == gridDim.x - 1)
    for (int s = s0 + tid; s < min(s0 + kGemmM, S); s += kGemmThreads)
      px[((size_t)s * B + b) * T1 + T] = kNegInf;
}

}  // namespace

// lmp (B, S+1, C), pxlm (B, S), pylm (B, S+1), lmmax (B, S+1) f32; symbols
// (B, S) and te (B,) int32 (te = -1: no t_end column); am (B, T, C) f32;
// uni (C,) f32 or NULL (plain build).
// Out: px (S, B, T or T+1), py (S+1, B, T) f32; nd (S+1, B, T) when uni is
// given; the residuals d (S+1, B, T), amax (B, T) and duni (B, T, smoothed
// only) where their pointers are not NULL.
extern "C" int frt_latbuild_fwd(const void* lmp, const void* pxlm, const void* pylm,
                                const void* lmmax, const void* sym, const void* te,
                                const void* am, const void* uni, int B, int S, int T, int C,
                                int blank, int modified, void* px, void* py, void* nd,
                                void* d_out, void* amax_out, void* duni_out, void* stream) {
  const int t_tiles = (T + kGemmN - 1) / kGemmN;
  const dim3 grid((unsigned)(t_tiles > 0 ? t_tiles : 1), (unsigned)((S + 1 + kGemmM - 1) / kGemmM),
                  (unsigned)B);
  latbuild_fwd_kernel<<<grid, kGemmThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lmp), static_cast<const float*>(pxlm),
      static_cast<const float*>(pylm), static_cast<const float*>(lmmax),
      static_cast<const int*>(sym), static_cast<const int*>(te), static_cast<const float*>(am),
      static_cast<const float*>(uni), B, S, T, C, blank, modified, static_cast<float*>(px),
      static_cast<float*>(py), static_cast<float*>(nd), static_cast<float*>(d_out),
      static_cast<float*>(amax_out), static_cast<float*>(duni_out));
  return (int)cudaGetLastError();
}
