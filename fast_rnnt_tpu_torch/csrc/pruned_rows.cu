// Pruned-lattice kernels for Hopper (sm_90a): the pruned joiner's logits
// [B, T, K, C] to the recursion's s-major rows px_rows [S, B, T(+1)] and
// py_rows [S+1, B, T], and the backward to d_logits.
//
// Replaces no Pallas kernel: the JAX package's get_rnnt_logprobs_pruned
// (fast_rnnt_tpu/ops/lattice.py) is jnp, left to XLA's fusions.  Added
// because the plain version (ops/kernels/pruned.py pruned_lattice_plain)
// places the [B, T, K] band values on the full lattice with K full-size
// selects for px and K for py, appends the -inf column, kills the t_end
// column in another full-size pass, and the recursion then copies px and
// py into s-major rows; autograd keeps ten full-size masks and runs every
// pass again backward.  In icefall's recipe at B 8, T 12000, S 1200, K 5,
// C 500 that is 28 ms a step on an H100.
//
// What bounds it.  The bytes: the logits read once forward (0.96 GB at that
// shape), px_rows and py_rows written once (0.92 GB), the logits read and
// d_logits written once backward (1.92 GB): ~3.8 GB a step, ~1.15 ms at
// 3.35 TB/s.  One exp a logit each way is far below the bytes.
//
// Design: each byte moved once, and nothing of size [B, T, S+1] kept for
// the backward, only the logits (which the caller holds) and a float32
// [B, T, K] normaliser.
//   1. band_kernel: one warp a (b, t, k) row of C logits, read in 16-byte
//      loads where C and the pointer allow.  A float32 log-sum-exp, each
//      lane's running sum rescaled chunk by chunk, then across the warp;
//      an infinite maximum shifts by 0, as torch.logsumexp's does.  It
//      writes lse, px_band = logit[symbol] - lse and py_band =
//      logit[termination] - lse, rounded to the logits' dtype where the
//      plain version rounds (the normaliser, then the difference).  The
//      symbol is that of row ranges[b, t, k] (the termination symbol at row
//      S), symbol 0 for a range outside [0, S], and a symbol outside [0, C)
//      reads 0, as the plain version's gathers do.
//   2. rows_kernel: one thread a frame t, over a run of rows s: the band
//      value where lo <= s < lo + K (lo = ranges[b, t, 0]), -inf elsewhere;
//      regular: -inf at t = T and at t = t_end; constrained: px + py[s+1],
//      rounded.  Neighbouring threads hold neighbouring frames, so the
//      segment of a row that a warp stores is contiguous.
//   3. bwd_kernel: one warp a (b, t, k): the band's cotangents gathered from
//      the rows' gradients (the killed t_end frame gives px none;
//      constrained: py[s+1] takes px[s]'s too), then
//      d_logits = onehot(symbol) g_px + onehot(termination) g_py
//                 - softmax (g_px + g_py)
//      in one read of the row and one write, in float32, rounded once.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace frt;

namespace {

constexpr int kWarps = 8;        // rows of logits a band or backward block
constexpr int kFrames = 256;     // frames a rows block
constexpr int kUnroll = 4;       // loads in flight a lane
constexpr int kMaxGridY = 65535;

enum Mode { kRegular = 0, kModified = 1, kConstrained = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename St>
__device__ __forceinline__ St from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// x rounded to the storage type, as a float: where the plain version's
// arithmetic in that type rounds its result
template <typename St>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<St>(x)); }

// element i of an index tensor, int32 or int64
__device__ __forceinline__ long long ld_idx(const void* p, long long i, int is64) {
  return is64 ? static_cast<const long long*>(p)[i] : static_cast<const int*>(p)[i];
}

template <typename St, int V>
struct alignas(sizeof(St) * V) Pack {
  St v[V];
};

// the shift of a running maximum: the maximum, or 0 where it is infinite
__device__ __forceinline__ float shift_of(float m) { return isinf(m) ? 0.f : m; }

// The column of row (b, rg) of the pruned symbols: the symbol of row rg
// (term_sym at row S), symbol 0 for rg outside [0, S]; -1 where it lies
// outside [0, C).  term_sym is -1 where the termination symbol does.
__device__ __forceinline__ int pruned_col(const void* symbols, int sym64, long long rg, int b,
                                          int S, int C, int term_sym) {
  long long sym = 0;
  if (rg >= 0 && rg <= S) sym = rg == S ? term_sym : ld_idx(symbols, (long long)b * S + rg, sym64);
  return sym >= 0 && sym < C ? (int)sym : -1;
}

// log-sum-exp of one row of C logits by a warp, in float32; C % V == 0
template <typename St, int V>
__device__ __forceinline__ float warp_lse(const St* __restrict__ x, int C, int lane) {
  using P = Pack<St, V>;
  const P* xp = reinterpret_cast<const P*>(x);
  const int np = C / V;
  float m = kNegInf, s = 0.f;
  for (int i = lane; i < np; i += 32 * kUnroll) {
    P buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + 32 * u < np) buf[u] = xp[i + 32 * u];
    float cm = kNegInf;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + 32 * u < np)
#pragma unroll
        for (int v = 0; v < V; ++v) cm = fmaxf(cm, to_f(buf[u].v[v]));
    const float nm = fmaxf(m, cm), sh = shift_of(nm);
    float acc = s == 0.f ? 0.f : s * expf(shift_of(m) - sh);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + 32 * u < np)
#pragma unroll
        for (int v = 0; v < V; ++v) acc += expf(to_f(buf[u].v[v]) - sh);
    m = nm;
    s = acc;
  }
  float M = m;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, d));
  const float sh = shift_of(M);
  const float t = warp_sum(s == 0.f ? 0.f : s * expf(shift_of(m) - sh));
  return sh + logf(t);
}

template <typename St, int V>
__global__ void __launch_bounds__(32 * kWarps)
band_kernel(const St* __restrict__ logits, const void* symbols, const void* ranges, int rows,
            int T, int K, int S, int C, int term_sym, int term_col, int sym64, int rg64,
            St* __restrict__ px_band, St* __restrict__ py_band, float* __restrict__ lse_out) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const St* x = logits + (long long)row * C;
  const float lse = warp_lse<St, V>(x, C, lane);
  if (lane != 0) return;
  const int b = row / (T * K);
  const int col = pruned_col(symbols, sym64, ld_idx(ranges, row, rg64), b, S, C, term_sym);
  const float nrm = rnd<St>(lse);
  const float xs = col >= 0 ? to_f(x[col]) : 0.f;
  px_band[row] = from_f<St>(xs - nrm);
  py_band[row] = from_f<St>(to_f(x[term_col]) - nrm);
  lse_out[row] = lse;
}

template <typename St>
__global__ void __launch_bounds__(kFrames)
rows_kernel(const St* __restrict__ px_band, const St* __restrict__ py_band, const void* ranges,
            const void* bnd, int B, int T, int T1, int K, int S, int mode, int per, int n_tiles,
            int rg64, int bnd64, St* __restrict__ px_rows, St* __restrict__ py_rows) {
  const int b = blockIdx.x / n_tiles;
  const int t = (blockIdx.x % n_tiles) * kFrames + threadIdx.x;
  if (t >= T1) return;
  const int s0 = blockIdx.y * per, s1 = min(s0 + per, S + 1);
  const bool frame = t < T && K > 0;
  const long long band = ((long long)b * T + t) * K;
  const long long lo = frame ? ld_idx(ranges, band, rg64) : 0;
  const bool kill = mode == kRegular &&
                    (t == T || (bnd != nullptr && t == ld_idx(bnd, 4LL * b + 3, bnd64)));
  for (int s = s0; s < s1; ++s) {
    const long long d = s - lo;
    const bool in = frame && d >= 0 && d < K;
    if (t < T)
      py_rows[((long long)s * B + b) * T + t] = in ? py_band[band + d] : from_f<St>(kNegInf);
    if (s < S) {
      float px = in && !kill ? to_f(px_band[band + d]) : kNegInf;
      if (mode == kConstrained) {
        const bool next = frame && d + 1 >= 0 && d + 1 < K;
        px = rnd<St>(px + (next ? to_f(py_band[band + d + 1]) : kNegInf));
      }
      px_rows[((long long)s * B + b) * T1 + t] = from_f<St>(px);
    }
  }
}

template <typename St, int V>
__global__ void __launch_bounds__(32 * kWarps)
bwd_kernel(const St* __restrict__ logits, const float* __restrict__ lse,
           const St* __restrict__ gpx, const St* __restrict__ gpy, const void* symbols,
           const void* ranges, const void* bnd, int rows, int B, int T, int T1, int K, int S,
           int C, int term_sym, int term_col, int mode, int sym64, int rg64, int bnd64,
           St* __restrict__ d_logits) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int lane = threadIdx.x & 31;
  const int bt = row / K, k = row % K, b = bt / T, t = bt % T;
  // every lane reads the same few values (one broadcast load each)
  const long long j = ld_idx(ranges, (long long)bt * K, rg64) + k;
  const bool kill = mode == kRegular && bnd != nullptr && t == ld_idx(bnd, 4LL * b + 3, bnd64);
  float gx = 0.f, gy = 0.f;
  if (j >= 0 && j < S && !kill) gx = to_f(gpx[(j * B + b) * T1 + t]);
  if (j >= 0 && j <= S) {
    gy = to_f(gpy[(j * B + b) * T + t]);
    if (mode == kConstrained && j >= 1) gy += to_f(gpx[((j - 1) * B + b) * T1 + t]);
  }
  const int col = pruned_col(symbols, sym64, ld_idx(ranges, row, rg64), b, S, C, term_sym);
  const float l = lse[row], g = gx + gy;
  using P = Pack<St, V>;
  const P* xp = reinterpret_cast<const P*>(logits + (long long)row * C);
  P* dp = reinterpret_cast<P*>(d_logits + (long long)row * C);
  const int np = C / V;
  for (int i = lane; i < np; i += 32 * kUnroll) {
    P buf[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (i + 32 * u < np) buf[u] = xp[i + 32 * u];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + 32 * u >= np) continue;
      P out;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const int c = (i + 32 * u) * V + v;
        float d = -expf(to_f(buf[u].v[v]) - l) * g;
        if (c == col) d += gx;
        if (c == term_col) d += gy;
        out.v[v] = from_f<St>(d);
      }
      dp[i + 32 * u] = out;
    }
  }
}

int row_blocks(int rows) { return (rows + kWarps - 1) / kWarps; }

template <typename St, int V>
int band_v(const void* logits, const void* symbols, const void* ranges, int B, int T, int K,
           int S, int C, int term_sym, int term_col, int sym64, int rg64, void* px_band,
           void* py_band, void* lse, cudaStream_t st) {
  const int rows = B * T * K;
  band_kernel<St, V><<<row_blocks(rows), 32 * kWarps, 0, st>>>(
      static_cast<const St*>(logits), symbols, ranges, rows, T, K, S, C, term_sym, term_col,
      sym64, rg64, static_cast<St*>(px_band), static_cast<St*>(py_band),
      static_cast<float*>(lse));
  return (int)cudaGetLastError();
}

template <typename St, int V>
int bwd_v(const void* logits, const void* lse, const void* gpx, const void* gpy,
          const void* symbols, const void* ranges, const void* bnd, int B, int T, int T1, int K,
          int S, int C, int term_sym, int term_col, int mode, int sym64, int rg64, int bnd64,
          void* d_logits, cudaStream_t st) {
  const int rows = B * T * K;
  bwd_kernel<St, V><<<row_blocks(rows), 32 * kWarps, 0, st>>>(
      static_cast<const St*>(logits), static_cast<const float*>(lse),
      static_cast<const St*>(gpx), static_cast<const St*>(gpy), symbols, ranges, bnd, rows, B,
      T, T1, K, S, C, term_sym, term_col, mode, sym64, rg64, bnd64, static_cast<St*>(d_logits));
  return (int)cudaGetLastError();
}

// the widest load a row allows (the wrapper picks it): V elements of at
// most 16 bytes, C % V == 0, the pointers aligned to V elements
template <typename St>
int launch_band(int vec, const void* logits, const void* symbols, const void* ranges, int B, int T,
         int K, int S, int C, int term_sym, int term_col, int sym64, int rg64, void* px_band,
         void* py_band, void* lse, cudaStream_t st) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(St) == 2)
        return band_v<St, 8>(logits, symbols, ranges, B, T, K, S, C, term_sym, term_col, sym64,
                             rg64, px_band, py_band, lse, st);
      break;
    case 4:
      return band_v<St, 4>(logits, symbols, ranges, B, T, K, S, C, term_sym, term_col, sym64,
                           rg64, px_band, py_band, lse, st);
    case 2:
      return band_v<St, 2>(logits, symbols, ranges, B, T, K, S, C, term_sym, term_col, sym64,
                           rg64, px_band, py_band, lse, st);
    case 1:
      return band_v<St, 1>(logits, symbols, ranges, B, T, K, S, C, term_sym, term_col, sym64,
                           rg64, px_band, py_band, lse, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename St>
int launch_bwd(int vec, const void* logits, const void* lse, const void* gpx, const void* gpy,
        const void* symbols, const void* ranges, const void* bnd, int B, int T, int T1, int K,
        int S, int C, int term_sym, int term_col, int mode, int sym64, int rg64, int bnd64,
        void* d_logits, cudaStream_t st) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(St) == 2)
        return bwd_v<St, 8>(logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K, S, C,
                            term_sym, term_col, mode, sym64, rg64, bnd64, d_logits, st);
      break;
    case 4:
      return bwd_v<St, 4>(logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K, S, C,
                          term_sym, term_col, mode, sym64, rg64, bnd64, d_logits, st);
    case 2:
      return bwd_v<St, 2>(logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K, S, C,
                          term_sym, term_col, mode, sym64, rg64, bnd64, d_logits, st);
    case 1:
      return bwd_v<St, 1>(logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K, S, C,
                          term_sym, term_col, mode, sym64, rg64, bnd64, d_logits, st);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename St>
int launch_rows(const void* px_band, const void* py_band, const void* ranges, const void* bnd, int B,
         int T, int T1, int K, int S, int mode, int rg64, int bnd64, void* px_rows,
         void* py_rows, cudaStream_t st) {
  const int n_tiles = (T1 + kFrames - 1) / kFrames;
  const int least = (S + 1 + kMaxGridY - 1) / kMaxGridY, per = least > 8 ? least : 8;
  const dim3 grid(B * n_tiles, (S + 1 + per - 1) / per);
  rows_kernel<St><<<grid, kFrames, 0, st>>>(
      static_cast<const St*>(px_band), static_cast<const St*>(py_band), ranges, bnd, B, T, T1,
      K, S, mode, per, n_tiles, rg64, bnd64, static_cast<St*>(px_rows),
      static_cast<St*>(py_rows));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16 (logits, bands, rows, gradients);
// sym64 / rg64 / bnd64: whether symbols [B, S], ranges [B, T, K] and
// boundary [B, 4] are int64 (else int32); bnd may be NULL; term_sym is the
// termination symbol where it lies in [0, C), else -1; term_col its column.

// px_band, py_band: [B, T, K] in the logits' dtype; lse: [B, T, K] float32
extern "C" int frt_pruned_band(const void* logits, const void* symbols, const void* ranges, int B,
                               int T, int K, int S, int C, int term_sym, int term_col, int sym64,
                               int rg64, int dtype, int vec, void* px_band, void* py_band,
                               void* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_band<float>(vec, logits, symbols, ranges, B, T, K, S, C, term_sym, term_col, sym64,
                         rg64, px_band, py_band, lse, st);
    case 1:
      return launch_band<__nv_bfloat16>(vec, logits, symbols, ranges, B, T, K, S, C, term_sym,
                                 term_col, sym64, rg64, px_band, py_band, lse, st);
    case 2:
      return launch_band<__half>(vec, logits, symbols, ranges, B, T, K, S, C, term_sym, term_col,
                          sym64, rg64, px_band, py_band, lse, st);
  }
  return (int)cudaErrorInvalidValue;
}

// px_rows: [S, B, T1] (T1 = T + 1 regular, else T); py_rows: [S+1, B, T];
// mode 0 regular, 1 modified, 2 constrained
extern "C" int frt_pruned_rows(const void* px_band, const void* py_band, const void* ranges,
                               const void* bnd, int B, int T, int T1, int K, int S, int mode,
                               int rg64, int bnd64, int dtype, void* px_rows, void* py_rows,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_rows<float>(px_band, py_band, ranges, bnd, B, T, T1, K, S, mode, rg64, bnd64,
                         px_rows, py_rows, st);
    case 1:
      return launch_rows<__nv_bfloat16>(px_band, py_band, ranges, bnd, B, T, T1, K, S, mode, rg64,
                                 bnd64, px_rows, py_rows, st);
    case 2:
      return launch_rows<__half>(px_band, py_band, ranges, bnd, B, T, T1, K, S, mode, rg64, bnd64,
                          px_rows, py_rows, st);
  }
  return (int)cudaErrorInvalidValue;
}

// gpx: [S, B, T1] and gpy: [S+1, B, T], the rows' gradients, contiguous;
// d_logits: [B, T, K, C] in the logits' dtype
extern "C" int frt_pruned_bwd(const void* logits, const void* lse, const void* gpx,
                              const void* gpy, const void* symbols, const void* ranges,
                              const void* bnd, int B, int T, int T1, int K, int S, int C,
                              int term_sym, int term_col, int mode, int sym64, int rg64,
                              int bnd64, int dtype, int vec, void* d_logits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_bwd<float>(vec, logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K, S, C,
                        term_sym, term_col, mode, sym64, rg64, bnd64, d_logits, st);
    case 1:
      return launch_bwd<__nv_bfloat16>(vec, logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K,
                                S, C, term_sym, term_col, mode, sym64, rg64, bnd64, d_logits,
                                st);
    case 2:
      return launch_bwd<__half>(vec, logits, lse, gpx, gpy, symbols, ranges, bnd, B, T, T1, K, S, C,
                         term_sym, term_col, mode, sym64, rg64, bnd64, d_logits, st);
  }
  return (int)cudaErrorInvalidValue;
}
