// Relative-position attention for Hopper (sm_90a): icefall's
// RelPositionMultiheadAttention between its projections, flash-style.
//
// Replaces no Pallas kernel: the JAX package's model computes its attention
// in XLA.  Added because the plain version
// (ops/kernels/relpos_attention.py relpos_attention_plain) writes the
// (B, H, T, T) scores to device memory again and again: the bf16 qu k^T, its
// float32 copy, the shifted bd added, the scale, the key mask, the float32
// softmax, its bf16 copy; autograd keeps the float32 and bf16
// probabilities and runs a pass for each op backward.  In icefall's
// LibriSpeech conformer (12 blocks, 8 heads of 64, T up to ~435 frames) that
// was 59 ms a step on an H100, ~36% of it.
//
// The function, per (b, h), with c = hd^-0.5 and bd = bd_raw (B, H, T, L),
// L >= 2T-1, the product (q + v_h) p^T of the caller:
//   w[i, j] = (qu_i . k_j + bd[i, T-1-i+j]) c, -inf where key_mask[b, j] is
//             False;  P = softmax_j(w) in float32;
//   o_i = sum_j rnd(P[i, j]) v_j, rnd: to the inputs' dtype (the plain
//         version's .to(dt) before its product with v).
// Backward, dO given, D_i = dO_i . o_i:
//   dS = rnd(P (dO v^T - D) c)   (the cotangent of both qu k^T and bd; dO v^T
//        stays float32, as D does, so that they cancel where P is one-hot)
//   dqu = dS k;  dk = dS^T qu;  dv = rnd(P)^T dO;  d(bd_raw)[i, T-1-i+j] = dS,
//   0 at the addresses no (i, j) reaches.
//
// What bounds it.  The bytes: bd_raw read (2 bytes x B H T L) and
// d(bd_raw) written, and the (B, T, H, hd) operands; the products, 2 T^2 hd
// a head forward and 5 backward, are far below them at hd = 64.
//
// Design (bf16 and f16 at hd = 64, the tensor-core kernels): blocks of 4
// warps, 64 rows, each warp 16; products by mma.sync m16n8k16 (float32
// accumulators) on 64 x 64 tiles staged by cp.async in padded shared rows
// (72 elements: ldmatrix reads them without bank conflicts), double
// buffered.  Neither the scores nor the probabilities reach device memory.
// bd's tile rows start at odd offsets: each is staged as the nine 16-byte
// chunks that cover it and read at its shift, and d(bd_raw) leaves the same
// way, whole chunks in 16-byte stores (a tile's elements loaded and stored
// one by one cost several times its products).
//   1. fwd_tc: a block per (b, h, 64 queries), one pass over the key tiles
//      with the float32 running row max and sum (base 2); the probabilities,
//      scaled to the running max, are rounded before their product with v.
//      A key tile that is all masked adds 0 and is skipped.  It writes o in
//      (B, T, H, hd), which out_proj reads without a copy, and lse (B, H, T)
//      float32.
//   2. bq_tc: a block per (b, h, 64 queries): D from dO and o, then over the
//      key tiles P = exp(w - lse), dP, dS; d(bd_raw) written where dS
//      belongs and the rest of each of its rows zeroed, each address once;
//      dqu in registers.  It writes D for 3.
//   3. bkv_tc: a block per (b, h, 64 keys), over the query tiles: the same
//      P and dS transposed, dk and dv in registers.  No atomics anywhere.
// float32, or a head size other than 64 (at most 128): the same three
// passes on the CUDA cores, a warp per row (fwd_simt, bq_simt, bkv_simt),
// products in float32, as torch.matmul computes float32 with TF32 off.
//
// Every query row is computed, padded rows included, as the plain version
// computes them.  A row whose keys are all masked gives NaN, as the plain
// softmax does.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "common.cuh"

using namespace frt;

namespace {

constexpr int kTile = 64;       // rows (queries or keys) a tile
constexpr int kHd = 64;         // the tensor-core kernels' head size
constexpr int kLds = kHd + 8;   // a tile row in shared memory, padded
constexpr int kTcThreads = 128;
constexpr int kTileElems = kTile * kLds;
constexpr int kSimtRows = 8;    // warps (rows) a CUDA-core block
constexpr int kMaxHd = 128;     // the CUDA-core kernels' largest head size
constexpr int kPerLane = kMaxHd / 32;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Args {
  const void* q;        // (B, T, H, hd), strides sq
  const void* k;
  const void* v;
  const void* bd;       // (B, H, T, L), strides sbd, L, 1
  const uint8_t* mask;  // (B, T) bool, contiguous
  const void* o;        // (B, T, H, hd), contiguous (backward)
  const void* dout;     // (B, T, H, hd), strides sdo (backward)
  const float* lse;     // (B, H, T) (backward)
  long long sq[3], sk[3], sv[3], sdo[3];  // b, t, h strides in elements
  long long sbd[2];     // bd's (and dbd's) b and h strides; its rows are L apart
  long long nbd;        // bd's elements
  int B, T, H, hd;
  int L;                // bd's rows: (B, H, T, L), L >= 2T-1
  float scale;
  void* out;            // forward: o; backward: dq
  float* lse_out;       // forward: lse; backward: D
  void* dk;
  void* dv;
  void* dbd;            // (B, H, T, L)
};

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

// x rounded to the storage type, as a float
template <typename St>
__device__ __forceinline__ float rnd(float x) { return to_f(from_f<St>(x)); }

__device__ __forceinline__ float nan_f() { return __int_as_float(0x7fffffff); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, d));
  return v;
}

// row (b, t, h) of a (B, T, H, hd) tensor with strides s
__device__ __forceinline__ long long row_at(const long long* s, int b, int t, int h) {
  return b * s[0] + t * s[1] + h * s[2];
}

// element (b, h, i, T-1-i+j) of the (B, H, T, L) relative-position scores
__device__ __forceinline__ long long bd_at(const Args& a, int b, int h, int i, int j) {
  return b * a.sbd[0] + h * a.sbd[1] + (long long)i * a.L + (a.T - 1 - i + j);
}

// ---------------------------------------------------------------------------
// tensor-core helpers (bf16 / f16 operands, float32 accumulators)

template <typename St>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// two neighbouring elements, 4-byte aligned, in one store
template <typename St>
__device__ __forceinline__ void store2(St* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack2<St>(lo, hi);
}

template <typename St>
__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
template <>
__device__ __forceinline__ void mma<__half>(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// 16 bytes to shared memory, the first `bytes` of them from device memory
// and the rest zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows r0 .. r0+63 of (b, h) of a (B, T, H, 64) tensor into a shared tile;
// rows at or past T read as zeros
template <typename St>
__device__ __forceinline__ void load_tile(St* dst, const St* x, const long long* s, int b, int h,
                                          int r0, int T) {
  const St* base = x + b * s[0] + h * s[2];
  for (int c = threadIdx.x; c < kTile * (kHd / 8); c += kTcThreads) {
    const int r = c >> 3, ch = c & 7, t = r0 + r;
    const bool ok = t < T;
    cp_async16(dst + r * kLds + ch * 8, base + (ok ? t * s[1] : 0) + ch * 8, ok ? 16 : 0);
  }
}

// A fragments (m16 x k64) of tile rows r0 .. r0+15
template <typename St>
__device__ __forceinline__ void ld_a(uint32_t (&af)[4][4], const St* X, int r0, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(af[kk], X + (r0 + (lane & 15)) * kLds + 16 * kk + (lane >> 4) * 8);
}

// A fragments (m16 x k64) of an accumulator tile, rounded to St: the
// accumulator layout of n-tiles 2kk and 2kk+1 is the A layout of k-step kk
template <typename St>
__device__ __forceinline__ void acc_to_a(uint32_t (&af)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    af[kk][0] = pack2<St>(x[2 * kk][0], x[2 * kk][1]);
    af[kk][1] = pack2<St>(x[2 * kk][2], x[2 * kk][3]);
    af[kk][2] = pack2<St>(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    af[kk][3] = pack2<St>(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

__device__ __forceinline__ void zero_acc(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] = 0.f;
}

// acc (16 x 64) += A (16 x 64) B, B[kd][n] = X[n][kd]: X's rows are the columns
template <typename St>
__device__ __forceinline__ void mm_nt(float (&acc)[8][4], const uint32_t (&af)[4][4], const St* X,
                                      int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4(b, X + (16 * p + (lane & 7) + ((lane >> 4) & 1) * 8) * kLds + 16 * kk +
                     ((lane >> 3) & 1) * 8);
      mma<St>(acc[2 * p], af[kk], b);
      mma<St>(acc[2 * p + 1], af[kk], b + 2);
    }
}

// acc (16 x 64) += A (16 x 64) B, B[kd][n] = X[kd][n]
template <typename St>
__device__ __forceinline__ void mm_nn(float (&acc)[8][4], const uint32_t (&af)[4][4], const St* X,
                                      int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t b[4];
      ldsm_x4_t(b, X + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLds + 16 * p +
                       ((lane >> 4) & 1) * 8);
      mma<St>(acc[2 * p], af[kk], b);
      mma<St>(acc[2 * p + 1], af[kk], b + 2);
    }
}

// An accumulator element (n, e) of a thread sits at row g + 8 (e >> 1) and
// column 8 n + 2 t4 + (e & 1) of its warp's 16 x 64 tile.
__device__ __forceinline__ int acc_row(int g, int e) { return g + 8 * (e >> 1); }
__device__ __forceinline__ int acc_col(int n, int t4, int e) { return 8 * n + 2 * t4 + (e & 1); }

// The staged relative-position scores.  The tensor-core kernels take bd
// rows that start on 16 bytes (bd's b and h strides and L multiples of 8).
// Tile rows are queries i0 + r, tile columns keys j0 + c; bd row i holds
// (i, j) at column T-1-i+j, so a tile row is 64 contiguous elements at an
// offset that no alignment fixes.  A staged row holds the nine 16-byte
// chunks that cover them, from column T-1-i+j0 rounded down to 8: element
// (r, c) sits at r * kLds + shift(i) + c, shift(i) = (T-1-i) & 7, the same
// for every key tile.
__device__ __forceinline__ int bd_shift(int i, int T) { return (T - 1 - i) & 7; }

// bd index of the first staged element of row i, key tile j0
__device__ __forceinline__ long long bd_chunk0(long long bh0, int i, int j0, int T, int L) {
  return bh0 + (long long)i * L + ((T - 1 - i + j0) & ~7);
}

constexpr int kChunks = kLds / 8;  // 16-byte chunks a staged bd row

template <typename St>
__device__ __forceinline__ void load_bd(St* dst, const St* bd, long long bh0, long long n, int i0,
                                        int j0, int T, int L) {
  for (int c = threadIdx.x; c < kTile * kChunks; c += kTcThreads) {
    const int r = c / kChunks, ch = c % kChunks, i = i0 + r;
    if (i >= T) continue;
    const long long s = bd_chunk0(bh0, i, j0, T, L) + 8 * ch;
    const long long left = n - s;  // the last chunk of the tensor may be short
    const int bytes = left >= 8 ? 16 : left > 0 ? (int)left * (int)sizeof(St) : 0;
    cp_async16(dst + r * kLds + 8 * ch, bd + (bytes ? s : 0), bytes);
  }
}

// d(bd_raw) of the tile from its staged copy (the same layout), a 16-byte
// store a chunk.  A row's band of T values runs over the key tiles between
// its zeros: the chunk a tile shares with the next waits in carry (this
// tile's half in carry_out, the last tile's in carry_in); the first tile's
// head chunk and the last tile's tail chunk take the row's zeros.  Chunks
// past the band are the zeros of zero_rows.
template <typename St>
__device__ __forceinline__ void store_bd(St* dbd, const St* src, const St* carry_in,
                                         St* carry_out, long long bh0, int i0, int j0, int T,
                                         int L) {
  const int ncols = min(kTile, T - j0);
  const St zero = from_f<St>(0.f);
  for (int c = threadIdx.x; c < kTile * kChunks; c += kTcThreads) {
    const int r = c / kChunks, ch = c % kChunks, i = i0 + r;
    const int lo = 8 * ch - bd_shift(i, T);  // the tile column of the chunk's element 0
    if (i >= T || lo >= ncols) continue;
    union {
      uint4 u;
      St e[8];
    } x;
    x.u = *reinterpret_cast<const uint4*>(src + r * kLds + 8 * ch);
    for (int e = 0; e < -lo; ++e) x.e[e] = j0 == 0 ? zero : carry_in[8 * r + e];
    if (lo + 8 > ncols) {
      if (j0 + kTile < T) {  // the band goes on in the next tile
        for (int e = 0; e < 8; ++e) carry_out[8 * r + e] = x.e[e];
        continue;
      }
      for (int e = ncols - lo; e < 8; ++e) x.e[e] = zero;
    }
    *reinterpret_cast<uint4*>(dbd + bd_chunk0(bh0, i, j0, T, L) + 8 * ch) = x.u;
  }
}

// the zeros of rows i0 .. i0+63 that no tile's chunks cover: columns [0,
// T-1-i) and [2T-1-i, L) rounded inwards to whole chunks, a warp a row
template <typename St>
__device__ __forceinline__ void zero_rows(St* dbd, long long bh0, int i0, int T, int L, int w,
                                          int lane) {
  for (int r = w; r < kTile && i0 + r < T; r += kTcThreads / 32) {
    const int i = i0 + r;
    St* row = dbd + bh0 + (long long)i * L;
    const int a = (T - 1 - i) & ~7, z = (2 * T - 1 - i + 7) & ~7;
    for (int c = 8 * lane; c < a; c += 256) *reinterpret_cast<uint4*>(row + c) = make_uint4(0u, 0u, 0u, 0u);
    for (int c = z + 8 * lane; c < L; c += 256) *reinterpret_cast<uint4*>(row + c) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The base-2 scores of a query-major tile (rows queries 16 w + ..., columns
// keys): w = (s + bd) c log2(e), -inf where the key is masked or the row or
// column out of range.  ms: the tile's 64 key flags, a bit each.
template <typename St>
__device__ __forceinline__ void scores_q(float (&s)[8][4], const St* bds, const uint32_t* ms,
                                         const int (&sh)[2], const bool (&row_ok)[2], int w,
                                         float scale2, int g, int t4) {
  const unsigned long long bits = (unsigned long long)ms[1] << 32 | ms[0];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + acc_row(g, e), c = acc_col(n, t4, e);
      const float x = to_f(bds[r * kLds + sh[e >> 1] + c]);
      s[n][e] = row_ok[e >> 1] && (bits >> c & 1) ? (s[n][e] + x) * scale2 : kNegInf;
    }
}

// The same of a key-major tile (rows keys 16 w + ..., columns queries i0 + c)
template <typename St>
__device__ __forceinline__ void scores_k(float (&s)[8][4], const St* bds,
                                         const bool (&key_ok)[2], int w, int i0, int T,
                                         float scale2, int g, int t4) {
  // the shift of query i0 + 8 n + 2 t4 + f is that of i0 + 2 t4 + f
  const int sh[2] = {bd_shift(i0 + 2 * t4, T), bd_shift(i0 + 2 * t4 + 1, T)};
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + acc_row(g, e), c = acc_col(n, t4, e), i = i0 + c;
      const bool ok = key_ok[e >> 1] && i < T;
      const float x = ok ? to_f(bds[c * kLds + sh[e & 1] + r]) : 0.f;
      s[n][e] = ok ? (s[n][e] + x) * scale2 : kNegInf;
    }
}

// the tile's key flags into shared memory, a bit each, two words (key past
// T: 0); true where any key of the tile attends.  A barrier for the block.
__device__ __forceinline__ bool key_flags(uint32_t* ms, const uint8_t* maskrow, int j0, int T) {
  const int key = j0 + (threadIdx.x & (kTile - 1));
  const bool ok = key < T && maskrow[key];
  const uint32_t bits = __ballot_sync(0xffffffffu, ok);
  if (threadIdx.x < kTile && (threadIdx.x & 31) == 0) ms[threadIdx.x >> 5] = bits;
  return __syncthreads_or(ok);
}

// ---------------------------------------------------------------------------
// 1. forward: o and lse

template <typename St>
__global__ void __launch_bounds__(kTcThreads) fwd_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  St* Qs = reinterpret_cast<St*>(smem);
  St* Ks = Qs + kTileElems;      // [2] tiles
  St* Vs = Ks + 2 * kTileElems;  // [2]
  St* Bs = Vs + 2 * kTileElems;  // [2] staged bd
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Bs + 2 * kTileElems);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z, T = a.T;
  const int L = a.L;
  const int nk = (T + kTile - 1) / kTile;
  const St* q = static_cast<const St*>(a.q);
  const St* k = static_cast<const St*>(a.k);
  const St* v = static_cast<const St*>(a.v);
  const St* bd = static_cast<const St*>(a.bd);
  const uint8_t* maskrow = a.mask + (long long)b * T;
  const long long bh0 = b * a.sbd[0] + h * a.sbd[1];
  const long long nbd = a.nbd;
  const float scale2 = a.scale * kLog2e;
  int sh[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 16 * w + g + 8 * r;
    row_ok[r] = i < T;
    sh[r] = bd_shift(i, T);
  }

  load_tile(Qs, q, a.sq, b, h, i0, T);
  load_tile(Ks, k, a.sk, b, h, 0, T);
  load_tile(Vs, v, a.sv, b, h, 0, T);
  load_bd(Bs, bd, bh0, nbd, i0, 0, T, L);
  cp_commit();
  uint32_t qf[4][4];
  // online base-2 max and sum of each row (l a thread's share of its quad's)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[8][4];
  zero_acc(o);
  for (int jt = 0; jt < nk; ++jt) {
    const int buf = jt & 1, j0 = jt * kTile;
    if (jt + 1 < nk) {
      load_tile(Ks + (buf ^ 1) * kTileElems, k, a.sk, b, h, j0 + kTile, T);
      load_tile(Vs + (buf ^ 1) * kTileElems, v, a.sv, b, h, j0 + kTile, T);
      load_bd(Bs + (buf ^ 1) * kTileElems, bd, bh0, nbd, i0, j0 + kTile, T, L);
    }
    cp_commit();
    cp_wait<1>();
    const bool any = key_flags(Ms, maskrow, j0, T);
    if (jt == 0) ld_a(qf, Qs, 16 * w, lane);
    if (any) {
      float s[8][4];
      zero_acc(s);
      mm_nt(s, qf, Ks + buf * kTileElems, lane);
      scores_q(s, Bs + buf * kTileElems, Ms, sh, row_ok, w, scale2, g, t4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        const float shift = mn == kNegInf ? 0.f : mn;  // a row with no key yet: p = 0
        const float alpha = exp2f(m[r] - shift);
        l[r] *= alpha;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          o[n][2 * r] *= alpha;
          o[n][2 * r + 1] *= alpha;
          s[n][2 * r] = exp2f(s[n][2 * r] - shift);
          s[n][2 * r + 1] = exp2f(s[n][2 * r + 1] - shift);
          l[r] += s[n][2 * r] + s[n][2 * r + 1];
        }
        m[r] = mn;
      }
      uint32_t pf[4][4];
      acc_to_a<St>(pf, s);
      mm_nn(o, pf, Vs + buf * kTileElems, lane);
    }
    __syncthreads();
  }
  St* out = static_cast<St*>(a.out);
  const long long so[3] = {(long long)T * a.H * kHd, (long long)a.H * kHd, kHd};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int i = i0 + 16 * w + g + 8 * r;
    if (i >= T) continue;
    const bool ok = l[r] > 0.f;  // no key attends: NaN, as the plain softmax gives
    const float inv = ok ? 1.f / l[r] : nan_f();
    St* orow = out + row_at(so, b, i, h);
#pragma unroll
    for (int n = 0; n < 8; ++n) store2<St>(orow + acc_col(n, t4, 0), o[n][2 * r] * inv, o[n][2 * r + 1] * inv);
    if (t4 == 0)
      a.lse_out[((long long)b * a.H + h) * T + i] = ok ? (m[r] + log2f(l[r])) * kLn2 : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// 2. backward, by query tiles: D, dq, d(bd_raw)

template <typename St>
__global__ void __launch_bounds__(kTcThreads) bq_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  St* Qs = reinterpret_cast<St*>(smem);
  St* Gs = Qs + kTileElems;      // dO
  St* Ks = Gs + kTileElems;      // [2]
  St* Vs = Ks + 2 * kTileElems;  // [2]
  St* Bs = Vs + 2 * kTileElems;  // [2] staged bd, then the tile's dS in its place
  St* Cs = Bs + 2 * kTileElems;  // [2][64][8] the chunk a tile leaves to the next
  float* Ds = reinterpret_cast<float*>(Cs + 2 * kTile * 8);  // [64]
  uint32_t* Ms = reinterpret_cast<uint32_t*>(Ds + kTile);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int i0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z, T = a.T, H = a.H;
  const int L = a.L;
  const int nk = (T + kTile - 1) / kTile;
  const St* k = static_cast<const St*>(a.k);
  const St* v = static_cast<const St*>(a.v);
  const St* bd = static_cast<const St*>(a.bd);
  const uint8_t* maskrow = a.mask + (long long)b * T;
  const long long so[3] = {(long long)T * H * kHd, (long long)H * kHd, kHd};
  const long long bh0 = b * a.sbd[0] + h * a.sbd[1];
  const long long nbd = a.nbd;
  const float scale2 = a.scale * kLog2e;
  St* dbd = static_cast<St*>(a.dbd);

  load_tile(Qs, static_cast<const St*>(a.q), a.sq, b, h, i0, T);
  load_tile(Gs, static_cast<const St*>(a.dout), a.sdo, b, h, i0, T);
  cp_commit();
  load_tile(Ks, k, a.sk, b, h, 0, T);
  load_tile(Vs, v, a.sv, b, h, 0, T);
  load_bd(Bs, bd, bh0, nbd, i0, 0, T, L);
  cp_commit();
  cp_wait<1>();
  __syncthreads();
  // D = dO . o, a warp a row
  for (int r = w; r < kTile; r += kTcThreads / 32) {
    const int i = i0 + r;
    float d = 0.f;
    if (i < T) {
      const St* orow = static_cast<const St*>(a.o) + row_at(so, b, i, h);
      d = to_f(Gs[r * kLds + 2 * lane]) * to_f(orow[2 * lane]) +
          to_f(Gs[r * kLds + 2 * lane + 1]) * to_f(orow[2 * lane + 1]);
    }
    d = warp_sum(d);
    if (lane == 0) {
      Ds[r] = d;
      if (i < T) a.lse_out[((long long)b * H + h) * T + i] = d;
    }
  }
  __syncthreads();
  float lse2[2], D[2];
  int sh[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 16 * w + g + 8 * r;
    row_ok[r] = i < T;
    sh[r] = bd_shift(i, T);
    lse2[r] = row_ok[r] ? a.lse[((long long)b * H + h) * T + i] * kLog2e : 0.f;
    D[r] = Ds[16 * w + g + 8 * r];
  }
  float dq[8][4];
  zero_acc(dq);
  for (int jt = 0; jt < nk; ++jt) {
    const int buf = jt & 1, j0 = jt * kTile;
    if (jt + 1 < nk) {
      load_tile(Ks + (buf ^ 1) * kTileElems, k, a.sk, b, h, j0 + kTile, T);
      load_tile(Vs + (buf ^ 1) * kTileElems, v, a.sv, b, h, j0 + kTile, T);
      load_bd(Bs + (buf ^ 1) * kTileElems, bd, bh0, nbd, i0, j0 + kTile, T, L);
    }
    cp_commit();
    cp_wait<1>();
    const bool any = key_flags(Ms, maskrow, j0, T);
    float s[8][4];
    zero_acc(s);
    if (any) {
      uint32_t af[4][4];
      ld_a(af, Qs, 16 * w, lane);
      mm_nt(s, af, Ks + buf * kTileElems, lane);
      scores_q(s, Bs + buf * kTileElems, Ms, sh, row_ok, w, scale2, g, t4);
      float dp[8][4];
      zero_acc(dp);
      ld_a(af, Gs, 16 * w, lane);
      mm_nt(dp, af, Vs + buf * kTileElems, lane);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = exp2f(s[n][e] - lse2[e >> 1]);
          s[n][e] = s[n][e] == kNegInf ? 0.f : rnd<St>(p * (dp[n][e] - D[e >> 1]) * a.scale);
        }
      acc_to_a<St>(af, s);
      mm_nn(dq, af, Ks + buf * kTileElems, lane);
    }
    // dS (0 for a tile no key attends) staged where the warp read its rows
    // of bd, then stored
    St* Wb = Bs + buf * kTileElems;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        Wb[(16 * w + acc_row(g, e)) * kLds + sh[e >> 1] + acc_col(n, t4, e)] = from_f<St>(s[n][e]);
    __syncthreads();
    store_bd(dbd, Wb, Cs + (buf ^ 1) * kTile * 8, Cs + buf * kTile * 8, bh0, i0, j0, T, L);
    __syncthreads();
  }
  St* dq_out = static_cast<St*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + 16 * w + g + 8 * r;
    if (i >= T) continue;
    St* row = dq_out + row_at(so, b, i, h);
#pragma unroll
    for (int n = 0; n < 8; ++n) store2<St>(row + acc_col(n, t4, 0), dq[n][2 * r], dq[n][2 * r + 1]);
  }
  zero_rows(dbd, bh0, i0, T, L, w, lane);
}

// ---------------------------------------------------------------------------
// 3. backward, by key tiles: dk, dv

template <typename St>
__global__ void __launch_bounds__(kTcThreads) bkv_tc(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  St* Ks = reinterpret_cast<St*>(smem);
  St* Vs = Ks + kTileElems;
  St* Qs = Vs + kTileElems;      // [2]
  St* Gs = Qs + 2 * kTileElems;  // [2] dO
  St* Bs = Gs + 2 * kTileElems;  // [2] staged bd
  float* Ls = reinterpret_cast<float*>(Bs + 2 * kTileElems);  // [2][64] base-2 lse
  float* Ds = Ls + 2 * kTile;                                 // [2][64] D
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t4 = lane & 3;
  const int j0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z, T = a.T, H = a.H;
  const int L = a.L;
  const int nq = (T + kTile - 1) / kTile;
  const St* q = static_cast<const St*>(a.q);
  const St* dout = static_cast<const St*>(a.dout);
  const St* bd = static_cast<const St*>(a.bd);
  const uint8_t* maskrow = a.mask + (long long)b * T;
  const long long so[3] = {(long long)T * H * kHd, (long long)H * kHd, kHd};
  const long long bh0 = b * a.sbd[0] + h * a.sbd[1];
  const long long nbd = a.nbd;
  const float scale2 = a.scale * kLog2e;
  const float* lse = a.lse + ((long long)b * H + h) * T;
  const float* Dg = a.lse_out + ((long long)b * H + h) * T;
  St* dk_out = static_cast<St*>(a.dk);
  St* dv_out = static_cast<St*>(a.dv);

  const int key = j0 + (threadIdx.x & (kTile - 1));
  if (!__syncthreads_or(key < T && maskrow[key])) {  // no key of the tile attends: dk = dv = 0
    const St zero = from_f<St>(0.f);
    for (int c = threadIdx.x; c < kTile * kHd; c += kTcThreads) {
      const int j = j0 + c / kHd;
      if (j < T) {
        dk_out[row_at(so, b, j, h) + c % kHd] = zero;
        dv_out[row_at(so, b, j, h) + c % kHd] = zero;
      }
    }
    return;
  }
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 16 * w + g + 8 * r;
    key_ok[r] = j < T && maskrow[j];
  }
  auto stage = [&](int buf, int i0) {  // query tile i0's rows, bd, lse and D
    load_tile(Qs + buf * kTileElems, q, a.sq, b, h, i0, T);
    load_tile(Gs + buf * kTileElems, dout, a.sdo, b, h, i0, T);
    load_bd(Bs + buf * kTileElems, bd, bh0, nbd, i0, j0, T, L);
    const int r = threadIdx.x & (kTile - 1), i = i0 + r;
    if (threadIdx.x < kTile)
      Ls[buf * kTile + r] = i < T ? lse[i] * kLog2e : 0.f;
    else
      Ds[buf * kTile + r] = i < T ? Dg[i] : 0.f;
  };
  load_tile(Ks, static_cast<const St*>(a.k), a.sk, b, h, j0, T);
  load_tile(Vs, static_cast<const St*>(a.v), a.sv, b, h, j0, T);
  stage(0, 0);
  cp_commit();
  float dk[8][4], dv[8][4];
  zero_acc(dk);
  zero_acc(dv);
  for (int it = 0; it < nq; ++it) {
    const int buf = it & 1, i0 = it * kTile;
    if (it + 1 < nq) stage(buf ^ 1, i0 + kTile);
    cp_commit();
    cp_wait<1>();
    __syncthreads();
    const St* Qb = Qs + buf * kTileElems;
    const St* Gb = Gs + buf * kTileElems;
    float s[8][4], dp[8][4];
    uint32_t af[4][4];
    zero_acc(s);
    ld_a(af, Ks, 16 * w, lane);
    mm_nt(s, af, Qb, lane);
    scores_k(s, Bs + buf * kTileElems, key_ok, w, i0, T, scale2, g, t4);
    zero_acc(dp);
    ld_a(af, Vs, 16 * w, lane);
    mm_nt(dp, af, Gb, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = acc_col(n, t4, e);
        const bool ok = s[n][e] != kNegInf;
        const float p = ok ? exp2f(s[n][e] - Ls[buf * kTile + c]) : 0.f;
        dp[n][e] = ok ? rnd<St>(p * (dp[n][e] - Ds[buf * kTile + c]) * a.scale) : 0.f;
        s[n][e] = p;
      }
    acc_to_a<St>(af, s);
    mm_nn(dv, af, Gb, lane);
    acc_to_a<St>(af, dp);
    mm_nn(dk, af, Qb, lane);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + 16 * w + g + 8 * r;
    if (j >= T) continue;
    St* krow = dk_out + row_at(so, b, j, h);
    St* vrow = dv_out + row_at(so, b, j, h);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = acc_col(n, t4, 0);
      store2<St>(krow + c, dk[n][2 * r], dk[n][2 * r + 1]);
      store2<St>(vrow + c, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// the CUDA-core kernels: a warp a row, lane l holding dims l, l+32, ...

template <typename St>
__device__ __forceinline__ void row_to_smem(float* dst, const St* src, int hd, int lane) {
  for (int d = lane; d < hd; d += 32) dst[d] = to_f(src[d]);
  __syncwarp();
}

// x . y, x in shared memory (float), y a row of the tensor
template <typename St>
__device__ __forceinline__ float dot(const float* x, const St* y, int hd) {
  float s = 0.f;
  for (int d = 0; d < hd; ++d) s = fmaf(x[d], to_f(y[d]), s);
  return s;
}

template <typename St>
__global__ void __launch_bounds__(32 * kSimtRows) fwd_simt(Args a) {
  __shared__ float qs[kSimtRows][kMaxHd];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kSimtRows + w, h = blockIdx.y, b = blockIdx.z, T = a.T, hd = a.hd;
  if (i >= T) return;
  const St* k = static_cast<const St*>(a.k);
  const St* v = static_cast<const St*>(a.v);
  const St* bd = static_cast<const St*>(a.bd) + bd_at(a, b, h, i, 0);  // bd[j]: (i, j)
  const uint8_t* maskrow = a.mask + (long long)b * T;
  row_to_smem(qs[w], static_cast<const St*>(a.q) + row_at(a.sq, b, i, h), hd, lane);
  auto score = [&](int j) {
    return (dot(qs[w], k + row_at(a.sk, b, j, h), hd) + to_f(bd[j])) * a.scale;
  };
  float m = kNegInf, l = 0.f;
  for (int j0 = 0; j0 < T; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < T && maskrow[j];
    const float x = ok ? score(j) : kNegInf;
    const float mn = fmaxf(m, warp_max(x));
    if (mn == kNegInf) continue;
    l = l * expf(m - mn) + warp_sum(ok ? expf(x - mn) : 0.f);
    m = mn;
  }
  const float lse = l > 0.f ? m + logf(l) : kNegInf;
  float o[kPerLane] = {};
  for (int j0 = 0; j0 < T; j0 += 32) {
    const int j = j0 + lane;
    const bool ok = j < T && maskrow[j];
    const float p = ok ? rnd<St>(expf(score(j) - lse)) : 0.f;
    for (int src = 0; src < 32 && j0 + src < T; ++src) {
      const float pj = __shfl_sync(0xffffffffu, p, src);
      const St* vrow = v + row_at(a.sv, b, j0 + src, h);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (lane + 32 * u < hd) o[u] = fmaf(pj, to_f(vrow[lane + 32 * u]), o[u]);
    }
  }
  const long long so[3] = {(long long)T * a.H * hd, (long long)a.H * hd, hd};
  St* orow = static_cast<St*>(a.out) + row_at(so, b, i, h);
#pragma unroll
  for (int u = 0; u < kPerLane; ++u)
    if (lane + 32 * u < hd) orow[lane + 32 * u] = from_f<St>(l > 0.f ? o[u] : nan_f());
  if (lane == 0) a.lse_out[((long long)b * a.H + h) * T + i] = lse;
}

template <typename St>
__global__ void __launch_bounds__(32 * kSimtRows) bq_simt(Args a) {
  __shared__ float qs[kSimtRows][kMaxHd], gs[kSimtRows][kMaxHd];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int i = blockIdx.x * kSimtRows + w, h = blockIdx.y, b = blockIdx.z, T = a.T, hd = a.hd;
  const int H = a.H;
  if (i >= T) return;
  const St* k = static_cast<const St*>(a.k);
  const St* v = static_cast<const St*>(a.v);
  const long long bdrow = bd_at(a, b, h, i, 0) - (T - 1 - i);
  const St* bd = static_cast<const St*>(a.bd) + bdrow + (T - 1 - i);
  St* dbd = static_cast<St*>(a.dbd) + bdrow;
  const uint8_t* maskrow = a.mask + (long long)b * T;
  const long long so[3] = {(long long)T * H * hd, (long long)H * hd, hd};
  row_to_smem(qs[w], static_cast<const St*>(a.q) + row_at(a.sq, b, i, h), hd, lane);
  row_to_smem(gs[w], static_cast<const St*>(a.dout) + row_at(a.sdo, b, i, h), hd, lane);
  const St* orow = static_cast<const St*>(a.o) + row_at(so, b, i, h);
  float D = 0.f;
  for (int d = lane; d < hd; d += 32) D = fmaf(gs[w][d], to_f(orow[d]), D);
  D = warp_sum(D);
  const long long stat = ((long long)b * H + h) * T + i;
  if (lane == 0) a.lse_out[stat] = D;
  const float lse = a.lse[stat];
  float dq[kPerLane] = {};
  for (int j0 = 0; j0 < T; j0 += 32) {
    const int j = j0 + lane;
    float ds = 0.f;
    if (j < T && maskrow[j]) {
      const float x = (dot(qs[w], k + row_at(a.sk, b, j, h), hd) + to_f(bd[j])) * a.scale;
      const float dp = dot(gs[w], v + row_at(a.sv, b, j, h), hd);
      ds = rnd<St>(expf(x - lse) * (dp - D) * a.scale);
    }
    if (j < T) dbd[T - 1 - i + j] = from_f<St>(ds);
    for (int src = 0; src < 32 && j0 + src < T; ++src) {
      const float dsj = __shfl_sync(0xffffffffu, ds, src);
      const St* krow = k + row_at(a.sk, b, j0 + src, h);
#pragma unroll
      for (int u = 0; u < kPerLane; ++u)
        if (lane + 32 * u < hd) dq[u] = fmaf(dsj, to_f(krow[lane + 32 * u]), dq[u]);
    }
  }
  St* dqrow = static_cast<St*>(a.out) + row_at(so, b, i, h);
#pragma unroll
  for (int u = 0; u < kPerLane; ++u)
    if (lane + 32 * u < hd) dqrow[lane + 32 * u] = from_f<St>(dq[u]);
  const St zero = from_f<St>(0.f);
  for (int z = lane; z < a.L - T; z += 32) dbd[z < T - 1 - i ? z : z + T] = zero;  // [0, T-1-i), [2T-1-i, L)
}

template <typename St>
__global__ void __launch_bounds__(32 * kSimtRows) bkv_simt(Args a) {
  __shared__ float ks[kSimtRows][kMaxHd], vs[kSimtRows][kMaxHd];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * kSimtRows + w, h = blockIdx.y, b = blockIdx.z, T = a.T, hd = a.hd;
  const int H = a.H;
  if (j >= T) return;
  const St* q = static_cast<const St*>(a.q);
  const St* dout = static_cast<const St*>(a.dout);
  const St* bd = static_cast<const St*>(a.bd);
  const long long stat = ((long long)b * H + h) * T;
  row_to_smem(ks[w], static_cast<const St*>(a.k) + row_at(a.sk, b, j, h), hd, lane);
  row_to_smem(vs[w], static_cast<const St*>(a.v) + row_at(a.sv, b, j, h), hd, lane);
  float dk[kPerLane] = {}, dv[kPerLane] = {};
  if (a.mask[(long long)b * T + j]) {
    for (int i0 = 0; i0 < T; i0 += 32) {
      const int i = i0 + lane;
      float p = 0.f, ds = 0.f;
      if (i < T) {
        const float x =
            (dot(ks[w], q + row_at(a.sq, b, i, h), hd) + to_f(bd[bd_at(a, b, h, i, j)])) * a.scale;
        const float dp = dot(vs[w], dout + row_at(a.sdo, b, i, h), hd);
        const float pf = expf(x - a.lse[stat + i]);
        ds = rnd<St>(pf * (dp - a.lse_out[stat + i]) * a.scale);
        p = rnd<St>(pf);
      }
      for (int src = 0; src < 32 && i0 + src < T; ++src) {
        const float pi = __shfl_sync(0xffffffffu, p, src);
        const float dsi = __shfl_sync(0xffffffffu, ds, src);
        const St* qrow = q + row_at(a.sq, b, i0 + src, h);
        const St* grow = dout + row_at(a.sdo, b, i0 + src, h);
#pragma unroll
        for (int u = 0; u < kPerLane; ++u)
          if (lane + 32 * u < hd) {
            dv[u] = fmaf(pi, to_f(grow[lane + 32 * u]), dv[u]);
            dk[u] = fmaf(dsi, to_f(qrow[lane + 32 * u]), dk[u]);
          }
      }
    }
  }
  const long long so[3] = {(long long)T * H * hd, (long long)H * hd, hd};
  St* krow = static_cast<St*>(a.dk) + row_at(so, b, j, h);
  St* vrow = static_cast<St*>(a.dv) + row_at(so, b, j, h);
#pragma unroll
  for (int u = 0; u < kPerLane; ++u)
    if (lane + 32 * u < hd) {
      krow[lane + 32 * u] = from_f<St>(dk[u]);
      vrow[lane + 32 * u] = from_f<St>(dv[u]);
    }
}

// ---------------------------------------------------------------------------
// launches

constexpr int kFwdSmem = 7 * kTileElems * 2 + 8;
constexpr int kBqSmem = 8 * kTileElems * 2 + 2 * kTile * 8 * 2 + kTile * 4 + 8;
constexpr int kBkvSmem = 8 * kTileElems * 2 + 4 * kTile * 4;

template <typename K>
cudaError_t launch(K kernel, dim3 grid, int threads, int smem, cudaStream_t st, const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <typename St>
int launch_fwd(const Args& a, cudaStream_t st) {
  if constexpr (sizeof(St) == 2) {  // bf16, f16
    if (a.hd == kHd)
      return (int)launch(fwd_tc<St>, dim3((a.T + kTile - 1) / kTile, a.H, a.B), kTcThreads, kFwdSmem,
                         st, a);
  }
  return (int)launch(fwd_simt<St>, dim3((a.T + kSimtRows - 1) / kSimtRows, a.H, a.B), 32 * kSimtRows, 0,
                     st, a);
}

template <typename St>
int launch_bwd(const Args& a, cudaStream_t st) {
  cudaError_t err;
  if constexpr (sizeof(St) == 2) {
    if (a.hd == kHd) {
      const dim3 grid((a.T + kTile - 1) / kTile, a.H, a.B);
      err = launch(bq_tc<St>, grid, kTcThreads, kBqSmem, st, a);
      if (err != cudaSuccess) return (int)err;
      return (int)launch(bkv_tc<St>, grid, kTcThreads, kBkvSmem, st, a);
    }
  }
  const dim3 grid((a.T + kSimtRows - 1) / kSimtRows, a.H, a.B);
  err = launch(bq_simt<St>, grid, 32 * kSimtRows, 0, st, a);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(bkv_simt<St>, grid, 32 * kSimtRows, 0, st, a);
}

Args make_args(const void* q, const void* k, const void* v, const void* bd, const void* mask,
               const long long* strides, int B, int T, int H, int hd, int L, float scale) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.bd = bd;
  a.mask = static_cast<const uint8_t*>(mask);
  for (int d = 0; d < 3; ++d) {
    a.sq[d] = strides[d];
    a.sk[d] = strides[3 + d];
    a.sv[d] = strides[6 + d];
    a.sdo[d] = strides[9 + d];
  }
  for (int d = 0; d < 2; ++d) a.sbd[d] = strides[12 + d];
  a.nbd = strides[14];
  a.B = B;
  a.T = T;
  a.H = H;
  a.hd = hd;
  a.L = L;
  a.scale = scale;
  return a;
}

}  // namespace

// q, k, v: (B, T, H, hd) with the b, t, h strides strides[0:3], [3:6], [6:9]
// (the last stride 1); bd: (B, H, T, L), L >= 2T-1, (i, j) at column
// T-1-i+j, its b and h strides strides[12:14] (rows L apart, columns
// adjacent), its element count strides[14]; mask: (B, T) bool
// contiguous; o: (B, T, H, hd) contiguous; lse: (B, H, T) float32.
// dtype 0 float32, 1 bfloat16, 2 float16.
extern "C" int frt_relpos_fwd(const void* q, const void* k, const void* v, const void* bd,
                              const void* mask, const long long* strides, int B, int T, int H,
                              int hd, int L, float scale, int dtype, void* o, void* lse,
                              void* stream) {
  Args a = make_args(q, k, v, bd, mask, strides, B, T, H, hd, L, scale);
  a.out = o;
  a.lse_out = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(a, st);
    case 1: return launch_fwd<__nv_bfloat16>(a, st);
    case 2: return launch_fwd<__half>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the forward's inputs, its o and lse, and dout (strides strides[9:12]);
// writes dq, dk, dv (B, T, H, hd) contiguous, dbd (B, H, T, L) laid out as bd, and D
// (B, H, T) float32 scratch
extern "C" int frt_relpos_bwd(const void* q, const void* k, const void* v, const void* bd,
                              const void* mask, const void* o, const void* lse, const void* dout,
                              const long long* strides, int B, int T, int H, int hd, int L,
                              float scale, int dtype, void* dq, void* dk, void* dv, void* dbd,
                              void* D, void* stream) {
  Args a = make_args(q, k, v, bd, mask, strides, B, T, H, hd, L, scale);
  a.o = o;
  a.lse = static_cast<const float*>(lse);
  a.dout = dout;
  a.out = dq;
  a.dk = dk;
  a.dv = dv;
  a.dbd = dbd;
  a.lse_out = static_cast<float*>(D);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(a, st);
    case 1: return launch_bwd<__nv_bfloat16>(a, st);
    case 2: return launch_bwd<__half>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}
