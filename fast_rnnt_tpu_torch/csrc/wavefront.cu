// Lattice recursion kernels for Hopper (sm_90a): the forward recursion and
// the occupancy backward, s-major rows.
//
// Replace the Pallas TPU kernels of fast_rnnt_tpu/ops/kernels/wavefront.py:
//   wavefront_fwd_kernel  <- _fwd_kernel (:224, pallas_call :321)
//   wavefront_bwd_kernel  <- _bwd_kernel (:420, pallas_call :517)
//
// Design.  One thread block per utterance walks the rows s in order (the
// Pallas grid's sequential s axis becomes a loop inside the block); the
// previous row (forward: p[s-1]; backward: g[s+1]) stays in shared memory.
// Within a row the recursion along t is a first-order linear recurrence
// (log-semiring forward, ordinary algebra backward), solved as a scan:
// each thread folds a contiguous segment of ceil((T+1)/threads) cells
// serially, a block-wide scan of the segment composites (warp shuffles, then
// one warp over the warp totals) gives each segment its incoming value, and
// the segment is re-walked to emit its cells.  Rows are staged through shared
// memory so that every global load and store is coalesced along t.  The
// boundary rectangle and the pruning band (lo <= s < lo + K, lo edge-padded
// to T+1 columns) are masked in registers, so no masked copy of the lattice
// is ever made.  S == 0 needs no special case: the loop runs row 0 only.
//
// What bounds it.  The rows are a chain of S+1 dependent steps, each a few
// block barriers plus global latency, so the kernel is latency bound, not
// bandwidth bound: at B=30, T=1000, S=100 it moves ~37 MB (forward: px, py
// in, p out) but only 30 of the H100's 132 SMs have work.  Filling the card
// (several utterances or row-pipelining per SM) is later work.

#include <cuda_runtime.h>

#include "common.cuh"

using namespace frt;

namespace {

struct Bnd {
  int sb, tb, se, te;
};

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

__global__ void __launch_bounds__(1024)
wavefront_fwd_kernel(const float* __restrict__ px, const float* __restrict__ py,
                     const int* __restrict__ bnd, const int* __restrict__ lo, int K, int S,
                     int B, int T, int modified, float* __restrict__ p,
                     float* __restrict__ scores) {
  extern __shared__ float sm[];
  __shared__ Pair warp_tot[32];
  const int W = T + 1;
  const int T1 = modified ? T : T + 1;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* prev = sm;          // p[s-1, :]
  float* cur = sm + W;       // p[s, :]
  float* bias = sm + 2 * W;  // symbol arcs into row s (and the origin)
  float* coef = sm + 3 * W;  // coef[t] = py[s, t-1]
  float* xend = sm + 4 * W;  // p at the end of each thread's segment
  const Bnd q = {bnd[4 * b], bnd[4 * b + 1], bnd[4 * b + 2], bnd[4 * b + 3]};
  const int E = (W + nt - 1) / nt;
  const int t0 = min(tid * E, W), t1 = min(t0 + E, W);
  if (tid == 0) scores[b] = kNegInf;

  for (int s = 0; s <= S; ++s) {
    for (int t = tid; t < W; t += nt) {
      float a = kNegInf;
      if (s > 0) {
        const int tp = modified ? t - 1 : t;  // px column feeding cell t
        if (tp >= 0 && px_ok(q, s - 1, tp, modified, lo, b, T, K))
          a = prev[tp] + px[((size_t)(s - 1) * B + b) * T1 + tp];
      }
      if (s == q.sb && t == q.tb) a = 0.f;  // origin p[s_begin, t_begin] = 0
      bias[t] = a;
      coef[t] = (t >= 1 && py_ok(q, s, t - 1, lo, b, T, K))
                    ? py[((size_t)s * B + b) * T + t - 1]
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

__global__ void __launch_bounds__(1024)
wavefront_bwd_kernel(const float* __restrict__ px, const float* __restrict__ py,
                     const float* __restrict__ p, const int* __restrict__ bnd,
                     const int* __restrict__ lo, int K, const float* __restrict__ ans_grad,
                     int S, int B, int T, int modified, float* __restrict__ pxg,
                     float* __restrict__ pyg) {
  extern __shared__ float sm[];
  __shared__ Pair warp_tot[32];
  const int W = T + 1;
  const int T1 = modified ? T : T + 1;
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  float* gcur = sm;       // g[s, :]
  float* gnext = sm + W;  // g[s+1, :]
  // the scan runs over u = T - t; ca[u] = term2[t] (0 at t = T) and
  // cb[u] = symbol-arc occupancy + seed at t
  float* ca = sm + 2 * W;
  float* cb = sm + 3 * W;
  float* xend = sm + 4 * W;
  const Bnd q = {bnd[4 * b], bnd[4 * b + 1], bnd[4 * b + 2], bnd[4 * b + 3]};
  const float ag = ans_grad[b];
  const int E = (W + nt - 1) / nt;
  const int u0 = min(tid * E, W), u1 = min(u0 + E, W);
  for (int t = tid; t < W; t += nt) gnext[t] = 0.f;

  for (int s = S; s >= 0; --s) {
    // p rows s and s+1 are read from global memory (L1/L2-resident: row
    // s+1 was read in the previous step), which keeps shared memory at four
    // rows and so T up to ~14k
    const float* pcur = p + ((size_t)s * B + b) * W;
    const float* pnext = p + ((size_t)(s + 1) * B + b) * W;  // read only when s < S
    for (int t = tid; t < W; t += nt) {
      const float pc = pcur[t];
      float h = 0.f;
      if (s < S && t < T1) {
        const int tn = modified ? t + 1 : t;  // cell the arc enters in row s+1
        float hv = 0.f;
        if (px_ok(q, s, t, modified, lo, b, T, K))
          hv = safe_exp(pc + px[((size_t)s * B + b) * T1 + t] - pnext[tn]) * gnext[tn];
        pxg[((size_t)s * B + b) * T1 + t] = hv;
        h = hv;
      }
      if (s == q.se && t == q.te) h += ag;
      float c = 0.f;
      if (t < T && py_ok(q, s, t, lo, b, T, K))
        c = safe_exp(pc + py[((size_t)s * B + b) * T + t] - pcur[t + 1]);
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
    float* out = pyg + ((size_t)s * B + b) * T;
    for (int t = tid; t < T; t += nt) out[t] = ca[T - t] * gcur[t + 1];
    float* tmp = gcur;
    gcur = gnext;
    gnext = tmp;
    __syncthreads();  // ca and the new gcur are rewritten by the next row
  }
}

}  // namespace

extern "C" const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p: (S+1, B, T+1) f32 out; scores: (B,) f32 out; lo may be NULL (no band).
extern "C" int frt_wavefront_fwd(const void* px, const void* py, const void* bnd, const void* lo,
                                 int K, int S, int B, int T, int modified, void* p, void* scores,
                                 int threads, void* stream) {
  const size_t smem = (size_t)(4 * (T + 1) + threads) * sizeof(float);
  cudaFuncSetAttribute(wavefront_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  wavefront_fwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const int*>(bnd), static_cast<const int*>(lo), K, S, B, T, modified,
      static_cast<float*>(p), static_cast<float*>(scores));
  return (int)cudaGetLastError();
}

// pxg: (S, B, T') and pyg: (S+1, B, T) f32 out, seeded with ans_grad (B,).
extern "C" int frt_wavefront_bwd(const void* px, const void* py, const void* p, const void* bnd,
                                 const void* lo, int K, const void* ans_grad, int S, int B, int T,
                                 int modified, void* pxg, void* pyg, int threads, void* stream) {
  const size_t smem = (size_t)(4 * (T + 1) + threads) * sizeof(float);
  cudaFuncSetAttribute(wavefront_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  wavefront_bwd_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(p), static_cast<const int*>(bnd), static_cast<const int*>(lo), K,
      static_cast<const float*>(ans_grad), S, B, T, modified, static_cast<float*>(pxg),
      static_cast<float*>(pyg));
  return (int)cudaGetLastError();
}
