// Fused two-phase lattice recursion kernel for Hopper (sm_90a): the forward
// recursion and the occupancy backward seeded with ones in one launch,
// s-major rows, px/py stored as float, bfloat16 or float16.
//
// Replaces the Pallas TPU kernel of fast_rnnt_tpu/ops/kernels/wavefront.py:
//   wavefront_fused_kernel  <- _fused_kernel (:623, pallas_call :765)
//
// Design.  One thread block per utterance runs the ascending forward rows
// and then the descending backward rows with the row bodies of the split
// kernels (wavefront_rows.cuh), so it runs their op sequence: its results
// are meant to be bit-equal to wavefront_fwd_kernel followed by
// wavefront_bwd_kernel with ans_grad = 1.  Where p lives: one utterance's p
// is (S+1)(T+1) floats, 404 KB at S=100, T=1000, beyond the 227 KB of
// shared memory a block may have, so the forward phase writes p to a scratch
// tensor the wrapper allocates (12.1 MB at B=30, well inside the 50 MB L2)
// and the backward phase reads it back through L2 (ld.global.cg).  Shared
// memory holds four rows, as in the split kernels, so the fused kernel takes
// every shape they take (T <= 14,271) and has no cap of its own.
//
// What bounds it.  The same chain of 2(S+1) dependent rows as the split
// pair, on 30 of 132 SMs: latency, not bandwidth.  It saves one launch and
// the p round trip's trip to device memory (p stays in L2); px/py are read
// once per phase as in the split pair.  Keeping p in the distributed shared
// memory of a thread-block cluster (2 CTAs x 227 KB hold 404 KB) is later
// work.

#include <cuda_runtime.h>

#include "wavefront_rows.cuh"

using namespace frt;

namespace {

template <class St>
__global__ void __launch_bounds__(1024)
wavefront_fused_kernel(const St* __restrict__ px, const St* __restrict__ py,
                       const int* __restrict__ bnd, const int* __restrict__ lo, int K, int S,
                       int B, int T, int modified, float* p, float* __restrict__ scores,
                       St* __restrict__ pxg, St* __restrict__ pyg) {
  extern __shared__ float sm[];
  __shared__ Pair warp_tot[32];
  const Bnd q = load_bnd(bnd, blockIdx.x);
  fwd_rows(px, py, q, lo, K, S, B, T, modified, sm, warp_tot, p, scores);
  __syncthreads();  // every p row of this utterance is written before it is read
  bwd_rows<true>(px, py, p, q, lo, K, 1.f, S, B, T, modified, sm, warp_tot, pxg, pyg);
}

template <class St>
int launch_fused(const void* px, const void* py, const void* bnd, const void* lo, int K, int S,
                 int B, int T, int modified, void* p, void* scores, void* pxg, void* pyg,
                 int threads, cudaStream_t stream) {
  const size_t smem = wavefront_smem(T, threads);
  cudaFuncSetAttribute(wavefront_fused_kernel<St>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem);
  wavefront_fused_kernel<St><<<B, threads, smem, stream>>>(
      static_cast<const St*>(px), static_cast<const St*>(py), static_cast<const int*>(bnd),
      static_cast<const int*>(lo), K, S, B, T, modified, static_cast<float*>(p),
      static_cast<float*>(scores), static_cast<St*>(pxg), static_cast<St*>(pyg));
  return (int)cudaGetLastError();
}

}  // namespace

// p: (S+1, B, T+1) f32 scratch; scores: (B,) f32 out; pxg (S, B, T') and pyg
// (S+1, B, T) out in the storage type named by `dtype` (StorageCode); lo may
// be NULL (no band).
extern "C" int frt_wavefront_fused(const void* px, const void* py, const void* bnd,
                                   const void* lo, int K, int S, int B, int T, int modified,
                                   void* p, void* scores, void* pxg, void* pyg, int threads,
                                   int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_fused<float>(px, py, bnd, lo, K, S, B, T, modified, p, scores, pxg, pyg,
                                 threads, st);
    case kBF16:
      return launch_fused<__nv_bfloat16>(px, py, bnd, lo, K, S, B, T, modified, p, scores, pxg,
                                         pyg, threads, st);
    case kF16:
      return launch_fused<__half>(px, py, bnd, lo, K, S, B, T, modified, p, scores, pxg, pyg,
                                  threads, st);
  }
  return (int)cudaErrorInvalidValue;
}
