// Pruning-window kernel for Hopper (sm_90a): per frame, the start of the
// s_range-wide symbol window with the largest occupancy, then the boundary
// padding and the monotone / step-bound repair.
//
// Replaces the Pallas TPU kernel fast_rnnt_tpu/ops/kernels/ranges.py
// _kernel (:64, pallas_call :229, entry window_argmax_rows_pallas :136),
// including its fused post-pass (:112-133).
//
// For each (b, t): argmax over k of
//     sum_{j in [k, k+K)} py_grad[j, t] - px_grad[k-1, t]     (no px term at k = 0)
// keeping the first maximum (strict >), with the window sum kept as the
// Pallas kernel keeps it: add row i, drop row i-K; at K == 1 the row itself
// (exact).  Then frames t >= t_end - 1 get max(s_end - K + 1, 0), and the
// starts are repaired as adjust_pruning_lower_bound does: reverse cummin,
// s -> ramp - s with ramp = (adjust_step - 1) t, reverse cummin, clip at 0,
// s -> ramp - s.
//
// Design.  One block per utterance.  Each thread owns frames t (strided, so
// loads along t are coalesced) and walks s with a rolling window sum in
// registers: every occupancy is read once (py_grad twice: entering and
// leaving the window).  The window starts go to shared memory, and the two
// reverse cummins are block scans of min over u = T - 1 - t.
//
// What bounds it.  ~3 reads of an (S+1, B, T) f32 array, 36 MB at the
// headline shape: 11 us at 3.35 TB/s.  With one block per utterance only B
// SMs pull that traffic, and each thread's walk over s is a chain of
// dependent adds, so it is latency bound at small B.

#include <cuda_runtime.h>

#include <climits>

#include "common.cuh"

using namespace frt;

namespace {

__global__ void __launch_bounds__(1024)
ranges_kernel(const float* __restrict__ gy, const float* __restrict__ gx,
              const int* __restrict__ bnd, int S1, int B, int T, int T1x, int K,
              int adjust_step, int* __restrict__ out) {
  extern __shared__ int sbeg[];  // T window starts, then one int per thread
  __shared__ int warp_tot[32];
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int se = bnd[4 * b + 2], te = bnd[4 * b + 3];

  for (int t = tid; t < T; t += nt) {
    float acc = 0.f, best = 0.f;
    int arg = 0;
    for (int i = 0; i < S1; ++i) {
      float a;
      if (K == 1) {
        a = gy[((size_t)i * B + b) * T + t];
      } else {
        a = acc + gy[((size_t)i * B + b) * T + t];
        if (i >= K) a -= gy[((size_t)(i - K) * B + b) * T + t];
        acc = a;
      }
      const int k = i - (K - 1);  // window [k, k+K) is complete at row i
      if (k < 0) continue;
      const float score = k > 0 ? a - gx[((size_t)(k - 1) * B + b) * T1x + t] : a;
      if (k == 0 || score > best) {
        best = score;
        arg = k;
      }
    }
    // frames at and after t_end - 1 get the final window start
    sbeg[t] = t < te - 1 ? arg : max(se - K + 1, 0);
  }
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

}  // namespace

// gy (S1, B, T), gx (S1-1, B, T1x) f32 occupancies (gx read at [:, :, :T]);
// boundary (B, 4) int32.  Out: (B, T) int32 repaired window starts.
extern "C" int frt_ranges(const void* gy, const void* gx, const void* bnd, int S1, int B, int T,
                          int T1x, int K, int adjust_step, void* out, int threads,
                          void* stream) {
  const size_t smem = (size_t)(T + threads) * sizeof(int);
  cudaFuncSetAttribute(ranges_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ranges_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(gy), static_cast<const float*>(gx),
      static_cast<const int*>(bnd), S1, B, T, T1x, K, adjust_step, static_cast<int*>(out));
  return (int)cudaGetLastError();
}
