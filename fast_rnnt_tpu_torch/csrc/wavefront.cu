// Row-scan lattice recursion kernels for Hopper (sm_90a): the forward
// recursion and the occupancy backward, s-major rows, px/py stored as float,
// bfloat16 or float16 (the recursion computes in float; p and scores are
// float).
//
// The first port of the Pallas TPU kernels of
// fast_rnnt_tpu/ops/kernels/wavefront.py:
//   scan_fwd_kernel  <- _fwd_kernel (:224, pallas_call :321)
//   scan_bwd_kernel  <- _bwd_kernel (:420, pallas_call :517)
// The package runs the diagonal sweep's phases (wavefront_fused.cu) in their
// place; these stay as the yardstick they are timed against
// (forward_rows_scan / backward_rows_scan in ops/kernels/wavefront.py).
//
// Design.  One thread block per utterance walks the rows s in order (the
// Pallas grid's sequential s axis becomes a loop inside the block); the
// previous row (forward: p[s-1]; backward: g[s+1]) stays in shared memory.
// The row bodies live in wavefront_rows.cuh.  The boundary rectangle and the pruning band
// (lo <= s < lo + K, lo edge-padded to T+1 columns) are masked in registers,
// so no masked copy of the lattice is ever made.  S == 0 needs no special
// case: the loop runs row 0 only.
//
// What bounds it.  The rows are a chain of S+1 dependent steps, each a few
// block barriers plus global latency, so the kernel is latency bound, not
// bandwidth bound: at B=30, T=1000, S=100 it moves ~37 MB (forward: px, py
// in, p out) but only 30 of the H100's 132 SMs have work.  Filling the card
// (several utterances or row-pipelining per SM) is later work.

#include <cuda_runtime.h>

#include "wavefront_rows.cuh"

using namespace frt;

namespace {

template <class St>
__global__ void __launch_bounds__(1024)
scan_fwd_kernel(const St* __restrict__ px, const St* __restrict__ py,
                     const int* __restrict__ bnd, const int* __restrict__ lo, int K, int S,
                     int B, int T, int modified, float* __restrict__ p,
                     float* __restrict__ scores) {
  extern __shared__ float sm[];
  __shared__ Pair warp_tot[32];
  fwd_rows(px, py, load_bnd(bnd, blockIdx.x), lo, K, S, B, T, modified, sm, warp_tot, p, scores);
}

template <class St>
__global__ void __launch_bounds__(1024)
scan_bwd_kernel(const St* __restrict__ px, const St* __restrict__ py,
                     const float* __restrict__ p, const int* __restrict__ bnd,
                     const int* __restrict__ lo, int K, const float* __restrict__ ans_grad,
                     int S, int B, int T, int modified, St* __restrict__ pxg,
                     St* __restrict__ pyg) {
  extern __shared__ float sm[];
  __shared__ Pair warp_tot[32];
  bwd_rows(px, py, p, load_bnd(bnd, blockIdx.x), lo, K, ans_grad[blockIdx.x], S, B, T,
                  modified, sm, warp_tot, pxg, pyg);
}

template <class St>
int launch_fwd(const void* px, const void* py, const void* bnd, const void* lo, int K, int S,
               int B, int T, int modified, void* p, void* scores, int threads,
               cudaStream_t stream) {
  const size_t smem = wavefront_smem(T, threads);
  cudaFuncSetAttribute(scan_fwd_kernel<St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  scan_fwd_kernel<St><<<B, threads, smem, stream>>>(
      static_cast<const St*>(px), static_cast<const St*>(py), static_cast<const int*>(bnd),
      static_cast<const int*>(lo), K, S, B, T, modified, static_cast<float*>(p),
      static_cast<float*>(scores));
  return (int)cudaGetLastError();
}

template <class St>
int launch_bwd(const void* px, const void* py, const void* p, const void* bnd, const void* lo,
               int K, const void* ans_grad, int S, int B, int T, int modified, void* pxg,
               void* pyg, int threads, cudaStream_t stream) {
  const size_t smem = wavefront_smem(T, threads);
  cudaFuncSetAttribute(scan_bwd_kernel<St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  scan_bwd_kernel<St><<<B, threads, smem, stream>>>(
      static_cast<const St*>(px), static_cast<const St*>(py), static_cast<const float*>(p),
      static_cast<const int*>(bnd), static_cast<const int*>(lo), K,
      static_cast<const float*>(ans_grad), S, B, T, modified, static_cast<St*>(pxg),
      static_cast<St*>(pyg));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// p: (S+1, B, T+1) f32 out; scores: (B,) f32 out; lo may be NULL (no band);
// px/py in the storage type named by `dtype` (StorageCode).
extern "C" int frt_scan_fwd(const void* px, const void* py, const void* bnd, const void* lo,
                            int K, int S, int B, int T, int modified, void* p, void* scores,
                            int threads, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fwd<float>(px, py, bnd, lo, K, S, B, T, modified, p, scores, threads, st);
    case kBF16:
      return launch_fwd<__nv_bfloat16>(px, py, bnd, lo, K, S, B, T, modified, p, scores,
                                       threads, st);
    case kF16:
      return launch_fwd<__half>(px, py, bnd, lo, K, S, B, T, modified, p, scores, threads, st);
  }
  return (int)cudaErrorInvalidValue;
}

// pxg: (S, B, T') and pyg: (S+1, B, T) out in the storage type, seeded with
// ans_grad (B,) f32; p f32.
extern "C" int frt_scan_bwd(const void* px, const void* py, const void* p, const void* bnd,
                            const void* lo, int K, const void* ans_grad, int S, int B, int T,
                            int modified, void* pxg, void* pyg, int threads, int dtype,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_bwd<float>(px, py, p, bnd, lo, K, ans_grad, S, B, T, modified, pxg, pyg,
                               threads, st);
    case kBF16:
      return launch_bwd<__nv_bfloat16>(px, py, p, bnd, lo, K, ans_grad, S, B, T, modified, pxg,
                                       pyg, threads, st);
    case kF16:
      return launch_bwd<__half>(px, py, p, bnd, lo, K, ans_grad, S, B, T, modified, pxg, pyg,
                                threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
