// Row bodies of the lattice recursion kernels (wavefront.cu, wavefront_fused.cu):
// the forward sweep over rows s = 0..S and the occupancy backward sweep over
// s = S..0, shared so that the split kernels and the fused kernel run the
// same op sequence.
//
// Storage dtypes.  px/py (and the occupancies written back) are stored as
// St = float, __nv_bfloat16 or __half; every value is widened to float as
// it is read and the recursion computes in float.  p is always float: it
// reaches |p| ~ 4e3 on a 1000-frame lattice, where a bf16 step is 16.
//
// Shared memory of either sweep: four (T+1)-float rows and one float per
// thread (the segment ends of the scan), plus 32 Pairs of scan scratch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace frt {

struct Bnd {
  int sb, tb, se, te;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <class St>
__device__ __forceinline__ St from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// band test lo[b, t] <= s < lo[b, t] + K, lo edge-padded to T+1 columns
__device__ __forceinline__ bool in_band(const int* lo, int b, int T, int t, int s, int K) {
  if (lo == nullptr) return true;
  const int l = T > 0 ? lo[(size_t)b * T + min(t, T - 1)] : 0;
  return l <= s && s < l + K;
}

// px[s, t] moves (s, t) -> (s+1, t) regular, (s+1, t+1) modified
__device__ __forceinline__ bool px_ok(const Bnd& q, int s, int t, int modified, const int* lo,
                                      int b, int T, int K) {
  const int t_hi = modified ? q.te - 1 : q.te;
  return s >= q.sb && s < q.se && t >= q.tb && t <= t_hi && in_band(lo, b, T, t, s, K);
}

// py[s, t] moves (s, t) -> (s, t+1)
__device__ __forceinline__ bool py_ok(const Bnd& q, int s, int t, const int* lo, int b, int T,
                                      int K) {
  return s >= q.sb && s <= q.se && t >= q.tb && t < q.te && in_band(lo, b, T, t, s, K);
}

__device__ __forceinline__ Bnd load_bnd(const int* bnd, int b) {
  return {bnd[4 * b], bnd[4 * b + 1], bnd[4 * b + 2], bnd[4 * b + 3]};
}

// Forward rows of utterance b = blockIdx.x: p[s, :] for s = 0..S into
// p (S+1, B, T+1), scores[b] = p[s_end, t_end].
//
// Within a row the recursion along t is a first-order linear recurrence in
// the log semiring, solved as a scan: each thread folds a contiguous segment
// of ceil((T+1)/threads) cells serially, a block-wide scan of the segment
// composites gives each segment its incoming value, and the segment is
// re-walked to emit its cells.  Rows are staged through shared memory so that
// every global load and store is coalesced along t.
template <class St>
__device__ __forceinline__ void fwd_rows(const St* __restrict__ px, const St* __restrict__ py,
                                         const Bnd& q, const int* __restrict__ lo, int K, int S,
                                         int B, int T, int modified, float* sm, Pair* warp_tot,
                                         float* p, float* __restrict__ scores) {
  const int W = T + 1;
  const int T1 = modified ? T : T + 1;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* prev = sm;          // p[s-1, :]
  float* cur = sm + W;       // p[s, :]
  float* bias = sm + 2 * W;  // symbol arcs into row s (and the origin)
  float* coef = sm + 3 * W;  // coef[t] = py[s, t-1]
  float* xend = sm + 4 * W;  // p at the end of each thread's segment
  const int E = (W + nt - 1) / nt;
  const int t0 = min(tid * E, W), t1 = min(t0 + E, W);
  if (tid == 0) scores[b] = kNegInf;

  for (int s = 0; s <= S; ++s) {
    for (int t = tid; t < W; t += nt) {
      float a = kNegInf;
      if (s > 0) {
        const int tp = modified ? t - 1 : t;  // px column feeding cell t
        if (tp >= 0 && px_ok(q, s - 1, tp, modified, lo, b, T, K))
          a = prev[tp] + to_f(px[((size_t)(s - 1) * B + b) * T1 + tp]);
      }
      if (s == q.sb && t == q.tb) a = 0.f;  // origin p[s_begin, t_begin] = 0
      bias[t] = a;
      coef[t] = (t >= 1 && py_ok(q, s, t - 1, lo, b, T, K))
                    ? to_f(py[((size_t)s * B + b) * T + t - 1])
                    : kNegInf;
    }
    __syncthreads();
    Pair loc = {0.f, kNegInf};
    for (int t = t0; t < t1; ++t) loc = LogOp()(loc, Pair{coef[t], bias[t]});
    const Pair inc = block_inclusive_scan(loc, LogOp(), warp_tot);
    xend[tid] = inc.b;
    __syncthreads();
    float x = tid > 0 ? xend[tid - 1] : kNegInf;
    for (int t = t0; t < t1; ++t) {
      x = log_add(x + coef[t], bias[t]);
      cur[t] = x;
    }
    __syncthreads();
    float* out = p + ((size_t)s * B + b) * W;
    for (int t = tid; t < W; t += nt) out[t] = cur[t];
    if (s == q.se && tid == 0) scores[b] = cur[q.te];
    float* tmp = prev;
    prev = cur;
    cur = tmp;
  }
}

// Occupancy backward rows of utterance b = blockIdx.x, seeded with ag at
// (s_end, t_end): px_grad (S, B, T') and py_grad (S+1, B, T) in St.  The
// scan runs over u = T - t in ordinary algebra.  p rows s and s+1 are read
// from global memory (row s+1 was read in the previous step), which keeps
// shared memory at four rows and so T up to ~14k.  kL2: read p through L2
// only (ld.global.cg), for a p written earlier by the same kernel, which the
// read-only cache path would not see coherently.
template <bool kL2, class St>
__device__ __forceinline__ void bwd_rows(const St* __restrict__ px, const St* __restrict__ py,
                                         const float* p, const Bnd& q,
                                         const int* __restrict__ lo, int K, float ag, int S,
                                         int B, int T, int modified, float* sm, Pair* warp_tot,
                                         St* __restrict__ pxg, St* __restrict__ pyg) {
  const int W = T + 1;
  const int T1 = modified ? T : T + 1;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* gcur = sm;       // g[s, :]
  float* gnext = sm + W;  // g[s+1, :]
  // ca[u] = term2[t] (0 at t = T) and cb[u] = symbol-arc occupancy + seed at t
  float* ca = sm + 2 * W;
  float* cb = sm + 3 * W;
  float* xend = sm + 4 * W;
  const int E = (W + nt - 1) / nt;
  const int u0 = min(tid * E, W), u1 = min(u0 + E, W);
  auto ldp = [](const float* a) { return kL2 ? __ldcg(a) : *a; };
  for (int t = tid; t < W; t += nt) gnext[t] = 0.f;

  for (int s = S; s >= 0; --s) {
    const float* pcur = p + ((size_t)s * B + b) * W;
    const float* pnext = p + ((size_t)(s + 1) * B + b) * W;  // read only when s < S
    for (int t = tid; t < W; t += nt) {
      const float pc = ldp(pcur + t);
      float h = 0.f;
      if (s < S && t < T1) {
        const int tn = modified ? t + 1 : t;  // cell the arc enters in row s+1
        float hv = 0.f;
        if (px_ok(q, s, t, modified, lo, b, T, K))
          hv = safe_exp(pc + to_f(px[((size_t)s * B + b) * T1 + t]) - ldp(pnext + tn)) * gnext[tn];
        pxg[((size_t)s * B + b) * T1 + t] = from_f<St>(hv);
        h = hv;
      }
      if (s == q.se && t == q.te) h += ag;
      float c = 0.f;
      if (t < T && py_ok(q, s, t, lo, b, T, K))
        c = safe_exp(pc + to_f(py[((size_t)s * B + b) * T + t]) - ldp(pcur + t + 1));
      ca[T - t] = c;
      cb[T - t] = h;
    }
    __syncthreads();
    Pair loc = {1.f, 0.f};
    for (int u = u0; u < u1; ++u) loc = LinOp()(loc, Pair{ca[u], cb[u]});
    const Pair inc = block_inclusive_scan(loc, LinOp(), warp_tot);
    xend[tid] = inc.b;
    __syncthreads();
    float x = tid > 0 ? xend[tid - 1] : 0.f;
    for (int u = u0; u < u1; ++u) {
      x = fmaf(ca[u], x, cb[u]);
      gcur[T - u] = x;
    }
    __syncthreads();
    St* out = pyg + ((size_t)s * B + b) * T;
    for (int t = tid; t < T; t += nt) out[t] = from_f<St>(ca[T - t] * gcur[t + 1]);
    float* tmp = gcur;
    gcur = gnext;
    gnext = tmp;
    __syncthreads();  // ca and the new gcur are rewritten by the next row
  }
}

// Storage-type codes of the C entries: 0 float, 1 bfloat16, 2 float16.
enum StorageCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

inline size_t wavefront_smem(int T, int threads) {
  return (size_t)(4 * (T + 1) + threads) * sizeof(float);
}

}  // namespace frt
