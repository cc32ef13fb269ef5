// Pruning-window kernels for Hopper (sm_90a): per frame, the start of the
// s_range-wide symbol window with the largest occupancy, then the boundary
// padding and the monotone / step-bound repair.
//
// Replaces the Pallas TPU kernel fast_rnnt_tpu/ops/kernels/ranges.py
// _kernel (:64, pallas_call :229, entry window_argmax_rows_pallas :136),
// including its fused post-pass (:112-133).
//
// For each (b, t): argmax over k in [0, S+1-K] of
//     sum_{j in [k, k+K)} py_grad[j, t] - px_grad[k-1, t]     (no px term at k = 0)
// keeping the first maximum.  The window sum is formed directly, its K
// terms added in row order (gy[k] + gy[k+1] + ... + gy[k+K-1], then
// - gx[k-1]), in float32 whatever the occupancies' storage dtype: a plain
// torch function (ops/kernels/ranges.py window_argmax_kernel_order)
// reproduces it bit for bit, and it carries no cancellation error (at K = 1
// the row itself).  Then frames t >= t_end - 1 get max(s_end - K + 1, 0),
// and the starts are repaired as adjust_pruning_lower_bound does: reverse
// cummin, s -> ramp - s with ramp = (adjust_step - 1) t, reverse cummin,
// clip at 0, s -> ramp - s.
//
// Design.  The Pallas kernel walks s as a sequential grid with a rolling
// window sum; here two kernels:
//   1. the argmax grid: one block per (32-frame tile, utterance), flattened
//      on gridDim.x (no cap on B), 256 threads.  The lane is the frame, so
//      each row segment a warp reads is one coalesced 128-byte load; the
//      8 warps split the window starts into contiguous slices, each warp
//      keeping its slice's first maximum, and the 8 winners are reduced in
//      shared memory (the larger score wins; on equal scores the smaller
//      k).  Every row s in [0, S] of a live frame is read: a window past
//      s_end scores 0 and wins where every in-range window scores below 0,
//      so the search may not stop at s_end.  Frames t >= t_end - 1 are not
//      searched (the padding writes them), and a tile holding none is
//      skipped.  The raw starts go to a (B, T) scratch.
//   2. the repair: one block per utterance reads the raw starts into
//      shared memory, pads, and runs the two reverse cummins as block scans
//      of min over u = T - 1 - t.
//
// What bounds it.  The bytes: every row of each live frame's occupancies
// (gy (S+1) rows, gx S rows), ~24 MB in float32 at the headline shape
// (B=30, T=1000, S=100), 7 us at 3.35 TB/s; the argmax grid's ~940 blocks
// keep every SM loading.  The window sums re-read K - 1 rows of each
// warp's slice from L1.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <climits>

#include "common.cuh"

using namespace frt;

namespace {

constexpr int kTile = 32;     // frames of an argmax block (its lanes)
constexpr int kWarps = 8;     // k slices of an argmax block
constexpr int kRepairMax = 1024;

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ float ld(const __half* p) { return __half2float(*p); }

template <typename St>
__global__ void __launch_bounds__(kTile * kWarps)
ranges_argmax_kernel(const St* __restrict__ gy, const St* __restrict__ gx,
                     const int* __restrict__ bnd, int S1, int B, int T, int T1x, int K,
                     int n_tiles, int* __restrict__ raw) {
  __shared__ float best_s[kWarps][kTile];
  __shared__ int arg_s[kWarps][kTile];
  const int b = blockIdx.x / n_tiles, t0 = (blockIdx.x % n_tiles) * kTile;
  const int te = bnd[4 * b + 3];
  if (t0 >= te - 1) return;  // every frame of the tile is padded
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = t0 + lane;
  const bool live = t < T && t < te - 1;
  // the warp's window starts [k0, k1), contiguous slices in warp order
  const int nk = S1 - K + 1, per = (nk + kWarps - 1) / kWarps;
  const int k0 = min(warp * per, nk), k1 = min(k0 + per, nk);
  float best = -FLT_MAX;
  int arg = INT_MAX;
  if (live) {
    const St* y = gy + (size_t)b * T + t;    // row j at y[j * B * T]
    const St* x = gx + (size_t)b * T1x + t;  // row j at x[j * B * T1x]
    const size_t ys = (size_t)B * T, xs = (size_t)B * T1x;
    // the slice's first maximum, in k order
    auto take = [&](int k, float a) {
      const float score = k > 0 ? a - ld(x + (k - 1) * xs) : a;
      if (k == k0 || score > best) {
        best = score;
        arg = k;
      }
    };
    int k = k0;
    for (; k + 4 <= k1; k += 4) {  // four windows at a time: four loads in flight
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = ld(y + (k + i) * ys);
      for (int j = 1; j < K; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] += ld(y + (k + i + j) * ys);
#pragma unroll
      for (int i = 0; i < 4; ++i) take(k + i, a[i]);
    }
    for (; k < k1; ++k) {
      float a = ld(y + k * ys);
      for (int j = 1; j < K; ++j) a += ld(y + (k + j) * ys);
      take(k, a);
    }
    if (k0 == k1) best = kNegInf;  // no starts: never wins
  }
  best_s[warp][lane] = best;
  arg_s[warp][lane] = arg;
  __syncthreads();
  if (warp == 0 && live) {
    for (int w = 1; w < kWarps; ++w) {
      const float s = best_s[w][lane];
      const int k = arg_s[w][lane];
      if (s > best || (s == best && k < arg)) {
        best = s;
        arg = k;
      }
    }
    raw[(size_t)b * T + t] = arg;
  }
}

__global__ void __launch_bounds__(kRepairMax)
ranges_repair_kernel(const int* __restrict__ raw, const int* __restrict__ bnd, int T, int K,
                     int adjust_step, int* __restrict__ out) {
  extern __shared__ int sbeg[];  // T window starts, then one int per thread
  __shared__ int warp_tot[32];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int se = bnd[4 * b + 2], te = bnd[4 * b + 3];
  // frames at and after t_end - 1 get the final window start
  for (int t = tid; t < T; t += nt) sbeg[t] = t < te - 1 ? raw[(size_t)b * T + t] : max(se - K + 1, 0);
  __syncthreads();

  // adjust_pruning_lower_bound: two reverse cummins over t, run as forward
  // block scans over u = T - 1 - t; thread `tid` owns a contiguous u segment
  const int E = (T + nt - 1) / nt;
  const int u0 = min(tid * E, T), u1 = min(u0 + E, T);
  int* xend = sbeg + T;  // cummin at the end of each thread's segment
  for (int pass = 0; pass < 2; ++pass) {
    int loc = INT_MAX;
    for (int u = u0; u < u1; ++u) loc = min(loc, sbeg[T - 1 - u]);
    xend[tid] = block_inclusive_scan(loc, MinOp(), warp_tot);
    __syncthreads();
    int x = tid > 0 ? xend[tid - 1] : INT_MAX;
    for (int u = u0; u < u1; ++u) {
      const int t = T - 1 - u;
      x = min(x, sbeg[t]);
      const int ramp = (adjust_step - 1) * t;
      // pass 0: s -> ramp - cummin(s);  pass 1: s -> ramp - max(cummin(s), 0)
      sbeg[t] = pass == 0 ? ramp - x : ramp - max(x, 0);
    }
    __syncthreads();
  }
  for (int t = tid; t < T; t += nt) out[(size_t)b * T + t] = sbeg[t];
}

template <typename St>
int launch(const void* gy, const void* gx, const int* bnd, int S1, int B, int T, int T1x, int K,
           int adjust_step, int* raw, int* out, int threads, cudaStream_t st) {
  const int n_tiles = (T + kTile - 1) / kTile;
  ranges_argmax_kernel<St><<<(unsigned)((long)B * n_tiles), kTile * kWarps, 0, st>>>(
      static_cast<const St*>(gy), static_cast<const St*>(gx), bnd, S1, B, T, T1x, K, n_tiles, raw);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)(T + threads) * sizeof(int);
  if ((err = cudaFuncSetAttribute(ranges_repair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return (int)err;
  ranges_repair_kernel<<<B, threads, smem, st>>>(raw, bnd, T, K, adjust_step, out);
  return (int)cudaGetLastError();
}

}  // namespace

// gy (S1, B, T), gx (S1-1, B, T1x) occupancies (gx read at [:, :, :T]) in
// float32 (dtype 0), bf16 (1) or float16 (2); boundary (B, 4) int32.
// Scratch: raw (B, T) int32, written where t < t_end - 1.  Out: (B, T)
// int32 repaired window starts; `threads` of the repair block (a multiple
// of 32, at most 1024).
extern "C" int frt_ranges(const void* gy, const void* gx, const void* bnd, int S1, int B, int T,
                          int T1x, int K, int adjust_step, void* raw, void* out, int threads,
                          int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* bd = static_cast<const int*>(bnd);
  int* r = static_cast<int*>(raw);
  int* o = static_cast<int*>(out);
  switch (dtype) {
    case 1:
      return launch<__nv_bfloat16>(gy, gx, bd, S1, B, T, T1x, K, adjust_step, r, o, threads, st);
    case 2:
      return launch<__half>(gy, gx, bd, S1, B, T, T1x, K, adjust_step, r, o, threads, st);
    default:
      return launch<float>(gy, gx, bd, S1, B, T, T1x, K, adjust_step, r, o, threads, st);
  }
}
