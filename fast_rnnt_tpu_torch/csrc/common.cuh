// Shared device helpers of the lattice kernels: -inf, a warp sum and a
// block-wide inclusive scan.
#pragma once

#include <cuda_runtime.h>
#include <limits>

namespace frt {

constexpr float kNegInf = -std::numeric_limits<float>::infinity();

// Sum over the 32 lanes of a warp; every lane gets the total.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
  return v;
}

struct MinOp {
  __device__ __forceinline__ int operator()(int l, int r) const { return min(l, r); }
};

__device__ __forceinline__ int shfl_up(int v, int d) {
  return __shfl_up_sync(0xffffffffu, v, d);
}

// Inclusive scan over the threads of the block, in thread order, of an
// associative op (l then r).  blockDim.x must be a multiple of 32 and every
// thread must call it.  `warp_tot` is shared scratch of 32 values.  Lanes
// only ever receive values from lower lanes, so no identity is needed.
template <class V, class Op>
__device__ V block_inclusive_scan(V v, Op op, V* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    V o = shfl_up(v, d);
    if (lane >= d) v = op(o, v);
  }
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    V w = warp_tot[lane < nw ? lane : 0];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      V o = shfl_up(w, d);
      if (lane >= d) w = op(o, w);
    }
    if (lane < nw) warp_tot[lane] = w;
  }
  __syncthreads();
  if (wid > 0) v = op(warp_tot[wid - 1], v);
  __syncthreads();  // warp_tot may be reused right after
  return v;
}

}  // namespace frt
