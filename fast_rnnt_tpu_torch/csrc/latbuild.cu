// Simple-lattice build for Hopper (sm_90a): (lm parts, am, symbols) ->
// s-major (px, py) rows, and for the smoothed lattice the third output
// normd; when a gradient is needed, also the residuals of the backward.
//
// Replaces the Pallas TPU kernel fast_rnnt_tpu/ops/kernels/latbuild.py
// _build_fwd_kernel, both variants: parts=False (:207, pallas_call :587,
// entry lattice_rows_fused :713) and parts=True (pallas_call :836, entry
// lattice_rows_fused_smoothed :968), with its save_d residual (:269).  The
// Pallas entry leaves the lm side (lmmax, lmp = exp(lm - lmmax), the
// per-(b, s) gathers pxlm and pylm) to XLA; here a first kernel of this
// file takes it and writes lmp straight into the products' operand layout.
// The unigram uni is the caller's plain-torch work.
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
// bf16 inputs (lm, am bf16), plain build, follow the JAX package's XLA
// build (fast_rnnt_tpu/ops/lattice.py:290-338): the exps are
// bf16(exp(bf16(am - amax))) and lmp arrives so rounded, their products are
// exact in float32, D is float32, and py's gather sum am[t, blank] +
// lm[s, blank] is rounded to bf16 before the normalizer is taken off.  The
// smoothed build (PALLAS) follows the Pallas kernel's bf16 mode (:233-288):
// the exps bf16(exp(am - amax)) of the float32 shift, the shifted gathers
// bf16(am[t, c] - amax) and the unigram row rounded to bf16, every sum
// float32.
// Float32 inputs take one of three operand modes (OP, the matmul precision
// levels, wgmma.cuh) for D's product and duni's: 2, 3xTF32 (the images'
// hi and lo parts); 1, one TF32 pass (the hi part alone, the A fragments
// rounded by cvt.rna); 0, one bf16 pass (a bf16 image of lmp and bf16 A
// fragments from the float32 am tile, as bf16 inputs run it).  duni's
// scalar products round both operands the same way (2: float32).  The
// rounded exps are CUDA's expf (operand_exp), the exp torch.exp takes, so
// the plain emulation rounds the same values.  bf16 inputs have the one
// mode 0.  The epilogue is the same in every mode.
//
// Design.  D is, per utterance, an (S+1) x T x C product, run here on the
// tensor cores (wgmma, wgmma.cuh).  `lm_parts_kernel` first takes the lm
// side (lmmax, the gathers) and writes the B operand exp(lm - lmmax) as
// TF32 hi / lo (or bf16) images in the wgmma layout.  Then one block (one
// warpgroup) per (64 frames, N tile of rows s, utterance): the N tile is
// S+1 rounded up to 8 rows (104 at S = 100; 32, 64, 104 or 128 rows, more
// tiles past 128), so am is read and exponentiated once.  The frames'
// contiguous am rows (64 x C, 128 KB at C = 500) come into shared memory by
// one bulk copy (by the threads where the range is not 16-byte aligned);
// amax, duni and the epilogue's symbol and blank gathers read that tile.
// exp(am - amax) is formed in registers as the A operand (every load of a
// chunk first), split into TF32 hi and lo (3xTF32, ~2^-21 relative per
// product; bf16 inputs: one bf16 product, exact), while the previous
// chunk's products run; a three-stage ring of 32-column (64 bf16) chunks
// of the B image, one bulk copy per part on an mbarrier, feeds them.  The
// epilogue stages each output in shared memory and writes it a row s at a
// time, the frames contiguous.  Where the tile does not fit (C > ~620
// fp32) the A operand and the gathers read am from device memory.
//
// What bounds it.  At the headline shape (B=30, T=1000, S=100, C=500) the
// product is 3.0 GFLOP, three TF32 passes 9.1 GFLOP (18 us at 495 TFLOP/s);
// the traffic is ~84 MB (am in, px and py out; +12 MB for D in training),
// 25 us at 3.35 TB/s: bytes bound it.  The kernel runs one 4-warp block per
// SM (the am tile), 480 blocks, each in turn loading its tile, taking amax,
// running the chunk loop (bound by forming the A fragments, not by the
// tensor cores) and storing, in turn.

#include <cuda_runtime.h>

#include <cfloat>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

using namespace frt;

namespace {

constexpr int kFwdStages = 3;

// The lm side, one block per (row s, utterance): lmmax[s] = max_c lm[s, c],
// pylm[s] = lm[s, blank], pxlm[s] = lm[s, sym_s] (0 for a symbol outside
// [0, C)), and the products' B operand exp(lm[s, c] - lmmax[s]) written
// straight into its image (operand mode OP: TF32 hi / lo parts, the hi part
// alone, or bf16), zero-padded to G groups and nK chunks (the padding rows'
// blocks write only zeros).
template <bool BF16, bool PALLAS, int OP>
__global__ void __launch_bounds__(128)
lm_parts_kernel(const void* __restrict__ lm_v, const int* __restrict__ sym, int S, int C, int blank,
                int nK, int G, float* __restrict__ lmmax, float* __restrict__ pylm,
                float* __restrict__ pxlm, void* __restrict__ img_hi, void* __restrict__ img_lo) {
  static_assert(!BF16 || OP == 0, "bf16 inputs have one operand mode");
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int kOpE = OP == 0 ? 2 : 4;  // bytes of an operand element
  constexpr int epc = 16 / kOpE, KC = 128 / kOpE;
  __shared__ float red[4];
  const int s = blockIdx.x, b = blockIdx.y, S1 = S + 1, tid = threadIdx.x;
  const bool live = s < S1;
  const Tin* row = static_cast<const Tin*>(lm_v) + ((size_t)b * S1 + min(s, S)) * C;
  float m = -FLT_MAX;
  if (live)
    for (int c = tid; c < C; c += 128) m = fmaxf(m, ld_f(row + c));
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  if ((tid & 31) == 0) red[tid >> 5] = m;
  __syncthreads();
  m = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
  if (live && tid == 0) {
    lmmax[(size_t)b * S1 + s] = m;
    pylm[(size_t)b * S1 + s] = ld_f(row + blank);
    if (s < S) {
      const int sy = sym[(size_t)b * S + s];
      pxlm[(size_t)b * S + s] = (sy >= 0 && sy < C) ? ld_f(row + sy) : 0.f;
    }
  }
  const size_t base = (size_t)b * nK;  // the utterance's first chunk
  for (int c = tid; c < nK * KC; c += 128) {
    const float v = (live && c < C) ? operand_exp<BF16, PALLAS, OP>(ld_f(row + c), m) : 0.f;
    const size_t i = ((((base + c / KC) * G + s / 8) * (KC / epc) + (c % KC) / epc) * 8 + s % 8) * epc + c % epc;
    if constexpr (OP == 0) {
      static_cast<__nv_bfloat16*>(img_hi)[i] = __float2bfloat16_rn(v);
    } else if constexpr (OP == 1) {
      static_cast<uint32_t*>(img_hi)[i] = to_tf32(v);
    } else {
      uint32_t h, l;
      split_tf32(v, h, l);
      static_cast<uint32_t*>(img_hi)[i] = h;
      static_cast<uint32_t*>(img_lo)[i] = l;
    }
  }
}

// am tile modes: kam_global reads am from device memory (the tile does not
// fit), kam_bulk copies the frames' contiguous rows with one bulk copy,
// kam_threads copies them with the block's threads (rows whose byte offsets
// are not 16-byte multiples)
enum { kam_global = 0, kam_bulk = 1, kam_threads = 2 };

constexpr int kFwdThreads = 128;  // one warpgroup

template <bool BF16, bool PALLAS, int OP, int NB8>
__global__ void __launch_bounds__(kFwdThreads, 1)
latbuild_fwd_kernel(const void* __restrict__ img_hi, const void* __restrict__ img_lo,
                    const float* __restrict__ pxlm, const float* __restrict__ pylm,
                    const float* __restrict__ lmmax, const int* __restrict__ sym,
                    const int* __restrict__ te_arr, const void* __restrict__ am_v,
                    const float* __restrict__ uni, int B, int S, int T, int C, int blank,
                    int modified, int G, int nK, int am_mode, float* __restrict__ px,
                    float* __restrict__ py, float* __restrict__ nd, float* __restrict__ d_out,
                    float* __restrict__ amax_out, float* __restrict__ duni_out) {
  static_assert(!BF16 || OP == 0, "bf16 inputs have one operand mode");
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr bool kBfOp = OP == 0;            // bf16 products (else TF32)
  constexpr int kParts = OP == 2 ? 2 : 1;    // image parts: hi (and lo)
  constexpr int kE = sizeof(Tin);            // bytes of an am element
  constexpr int kOpE = kBfOp ? 2 : 4;        // bytes of an operand element
  constexpr int KC = 128 / kOpE, KSTEP = 32 / kOpE;
  constexpr int NCOL = 8 * NB8;           // rows s of the block
  constexpr uint32_t kPart = NB8 * 1024;  // one chunk of the block's B rows
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* lmmax_s = reinterpret_cast<float*>(smem + kFwdStages * kParts * kPart);
  float* pylm_s = lmmax_s + NCOL;
  float* pxlm_s = pylm_s + NCOL;
  int* sym_s = reinterpret_cast<int*>(pxlm_s + NCOL);
  float* amax_s = reinterpret_cast<float*>(sym_s + NCOL);
  float* lduni_s = amax_s + 64;
  uint64_t* bars = reinterpret_cast<uint64_t*>(lduni_s + 64);
  Tin* tile = reinterpret_cast<Tin*>(bars + 8);  // 64 x C (resident modes), 16-byte aligned

  const int t0 = blockIdx.x * 64, n0 = blockIdx.y * NCOL, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int S1 = S + 1;
  const int T1 = modified ? T : T + 1;
  const int nrows = min(64, T - t0);
  const bool resident = am_mode != kam_global;
  const Tin* am_rows = static_cast<const Tin*>(am_v) + ((size_t)b * T + t0) * C;
  const size_t img_off = ((size_t)b * nK * G + n0 / 8) * 1024;
  const unsigned char* hi_b = static_cast<const unsigned char*>(img_hi) + img_off;
  const unsigned char* lo_b = OP == 2 ? static_cast<const unsigned char*>(img_lo) + img_off : nullptr;
  // the residuals (B, T) are written once, by the first N tile
  const bool row_owner = blockIdx.y == 0;

  auto issue = [&](int k) {
    const int st = k % kFwdStages;
    unsigned char* dst = ring + st * kParts * kPart;
    mbar_expect_tx(&bars[st], kParts * kPart);
    bulk_copy(dst, hi_b + (size_t)k * G * 1024, kPart, &bars[st]);
    if constexpr (OP == 2) bulk_copy(dst + kPart, lo_b + (size_t)k * G * 1024, kPart, &bars[st]);
  };
  if (tid == 0) {
    for (int i = 0; i <= kFwdStages; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    if (am_mode == kam_bulk && nrows > 0) {
      mbar_expect_tx(&bars[kFwdStages], (uint32_t)(nrows * C * kE));
      bulk_copy(tile, am_rows, nrows * C * kE, &bars[kFwdStages]);
    }
    for (int k = 0; k < min(kFwdStages, nK); ++k) issue(k);
  }
  // the block's per-row-s side values
  for (int j = tid; j < NCOL; j += kFwdThreads) {
    const int s = n0 + j;
    lmmax_s[j] = s < S1 ? lmmax[(size_t)b * S1 + s] : 0.f;
    pylm_s[j] = s < S1 ? pylm[(size_t)b * S1 + s] : 0.f;
    pxlm_s[j] = s < S ? pxlm[(size_t)b * S + s] : 0.f;
    const int sy = s < S ? sym[(size_t)b * S + s] : -1;
    // a symbol outside [0, C) reads am = 0, as the JAX package's one-hot
    // gather does (and never reads outside the row)
    sym_s[j] = (sy >= 0 && sy < C) ? sy : -1;
  }
  if (am_mode == kam_threads) {
    for (int i = tid; i < nrows * C; i += kFwdThreads) tile[i] = am_rows[i];
    __syncthreads();
  }
  if (am_mode == kam_bulk && nrows > 0) mbar_wait(&bars[kFwdStages], 0);

  // amax (and duni) of the block's frames, two threads per frame, each over
  // half the row with eight running maxima (sums); `base` is the shared
  // tile or device memory (a pointer of known space each call)
  constexpr int kPer = 2;  // threads per frame
  auto prologue = [&](const Tin* base) {
    const int r = tid / kPer, part = tid % kPer;
    const int t = t0 + r;
    const Tin* row = base + min(r, max(nrows - 1, 0)) * C;
    const int len = (C + kPer - 1) / kPer, cb = part * len, ce = min(C, cb + len);
    float mm[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mm[i] = -FLT_MAX;
    int c = cb;
    for (; c + 8 <= ce; c += 8)
#pragma unroll
      for (int i = 0; i < 8; ++i) mm[i] = fmaxf(mm[i], ld_f(row + c + i));
    for (; c < ce; ++c) mm[0] = fmaxf(mm[0], ld_f(row + c));
    float m = fmaxf(fmaxf(fmaxf(mm[0], mm[1]), fmaxf(mm[2], mm[3])),
                    fmaxf(fmaxf(mm[4], mm[5]), fmaxf(mm[6], mm[7])));
#pragma unroll
    for (int d = 1; d < kPer; d <<= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (part == 0) amax_s[r] = m;
    if (uni != nullptr) {
      // both operands (the unigram row and the exps) rounded in the
      // operand mode (PALLAS: bf16), exact products but in mode 2
      auto term = [&](int c, float uu) {
        const float e = expf(ld_f(row + c) - m);
        return fmaf(op_round<OP>(uni[c]), op_round<OP>(e), uu);
      };
      float uu[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) uu[i] = 0.f;
      for (c = cb; c + 8 <= ce; c += 8)
#pragma unroll
        for (int i = 0; i < 8; ++i) uu[i] = term(c + i, uu[i]);
      for (; c < ce; ++c) uu[0] = term(c, uu[0]);
      float u = ((uu[0] + uu[1]) + (uu[2] + uu[3])) + ((uu[4] + uu[5]) + (uu[6] + uu[7]));
#pragma unroll
      for (int d = 1; d < kPer; d <<= 1) u += __shfl_xor_sync(0xffffffffu, u, d);
      if (part == 0) {
        lduni_s[r] = logf(u);
        if (duni_out != nullptr && row_owner && r < nrows) duni_out[(size_t)b * T + t] = u;
      }
    }
    if (part == 0 && amax_out != nullptr && row_owner && r < nrows) amax_out[(size_t)b * T + t] = m;
  };
  if (resident)
    prologue(tile);
  else
    prologue(am_rows);
  __syncthreads();

  // A operand rows of this thread (wgmma fragment layout, wgmma.cuh); rows
  // past nrows and columns past C read a clamped element and are zeroed
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const bool v0 = r0 < nrows, v1 = r1 < nrows;
  const float m0 = amax_s[r0], m1 = amax_s[r1];
  const int o0 = min(r0, max(nrows - 1, 0)) * C, o1 = min(r1, max(nrows - 1, 0)) * C;
  auto amp = [&](float a, float mx, bool ok) -> float {
    const float e = operand_exp<BF16, PALLAS, OP>(a, mx);
    return ok ? e : 0.f;
  };
  // the chunk's fragments: every load first, then the exps and splits
  auto frag_from = [&](const Tin* base, int k, uint32_t(&h)[4][4], uint32_t(&l)[4][4]) {
    constexpr int kCols = kBfOp ? 4 : 2;  // columns per row in a k-step
    float a0[4][kCols], a1[4][kCols];
    int cc[4][kCols];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        const int c = k * KC + ks * KSTEP + (kBfOp ? 2 * q + (i & 1) + 8 * (i >> 1) : q + 4 * i);
        cc[ks][i] = c;
        const int cl = min(c, C - 1);
        a0[ks][i] = ld_f(base + o0 + cl);
        a1[ks][i] = ld_f(base + o1 + cl);
      }
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      float e0[kCols], e1[kCols];
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        e0[i] = amp(a0[ks][i], m0, v0 && cc[ks][i] < C);
        e1[i] = amp(a1[ks][i], m1, v1 && cc[ks][i] < C);
      }
      if constexpr (kBfOp) {
        h[ks][0] = pack_bf16(e0[0], e0[1]);
        h[ks][1] = pack_bf16(e1[0], e1[1]);
        h[ks][2] = pack_bf16(e0[2], e0[3]);
        h[ks][3] = pack_bf16(e1[2], e1[3]);
      } else if constexpr (OP == 1) {
        h[ks][0] = to_tf32(e0[0]);
        h[ks][1] = to_tf32(e1[0]);
        h[ks][2] = to_tf32(e0[1]);
        h[ks][3] = to_tf32(e1[1]);
      } else {
        split_tf32(e0[0], h[ks][0], l[ks][0]);
        split_tf32(e1[0], h[ks][1], l[ks][1]);
        split_tf32(e0[1], h[ks][2], l[ks][2]);
        split_tf32(e1[1], h[ks][3], l[ks][3]);
      }
    }
  };
  float acc[4 * NB8];
#pragma unroll
  for (int i = 0; i < 4 * NB8; ++i) acc[i] = 0.f;
  mainloop<kBfOp, OP == 2, OP == 2, NB8>(
      acc, nK, kPart,
      [&](int k) { mbar_wait(&bars[k % kFwdStages], (k / kFwdStages) & 1); },
      [&](int k, uint32_t(&h)[4][4], uint32_t(&l)[4][4]) {
        if (resident)
          frag_from(tile, k, h, l);
        else
          frag_from(am_rows, k, h, l);
      },
      [&](int k) { return smem_u32(ring + (k % kFwdStages) * kParts * kPart); },
      [&](int k) {
        __syncthreads();  // every product of chunk k is done: refill its stage
        if (tid == 0 && k + kFwdStages < nK) issue(k + kFwdStages);
      });

  // epilogue: every gather (am at the blank and at each row s's symbol)
  // first; then each output (D, normd, py, px) is staged in shared memory
  // (the ring is free) as NCOL rows s of 64 frames and written a row at a
  // time, the frames contiguous
  const int te = te_arr[b];
  float ab[2], ga[4 * NB8];
  auto gather = [&](const Tin* base) {
#pragma unroll
    for (int h = 0; h < 2; ++h) ab[h] = ld_f(base + (h ? o1 : o0) + blank);
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ga[4 * j + e] = ld_f(base + (e < 2 ? o0 : o1) + max(sym_s[8 * j + 2 * q + (e & 1)], 0));
  };
  if (resident)
    gather(tile);
  else
    gather(am_rows);
  constexpr int LD = 65;  // staging row stride (floats)
  float* ost = reinterpret_cast<float*>(ring);  // [NCOL][LD]
  // out[s, b, t] (row length Tout) for the block's rows s < s_end
  auto flush = [&](float* out, int Tout, int s_end) {
    __syncthreads();
    for (int i = tid; i < NCOL * 64; i += kFwdThreads) {
      const int jl = i >> 6, r = i & 63, s = n0 + jl;
      if (s < s_end && r < nrows) out[((size_t)s * B + b) * Tout + t0 + r] = ost[jl * LD + r];
    }
    __syncthreads();
  };
  auto stage = [&](auto value) {
#pragma unroll
    for (int j = 0; j < NB8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int jl = 8 * j + 2 * q + (e & 1), r = e < 2 ? r0 : r1;
        ost[jl * LD + r] = value(j, e, jl, r);
      }
  };
  __syncthreads();  // the ring's last chunk is consumed by every warp
  if (d_out != nullptr) {
    stage([&](int j, int e, int, int) { return acc[4 * j + e] + FLT_MIN; });
    flush(d_out, T, S1);
  }
  // acc becomes lognorm = log D + lmmax
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = __logf(acc[4 * j + e] + FLT_MIN) + lmmax_s[8 * j + 2 * q + (e & 1)];
  if (nd != nullptr) {
    stage([&](int j, int e, int, int r) { return acc[4 * j + e] - lduni_s[r]; });
    flush(nd, T, S1);
  }
  stage([&](int j, int e, int jl, int r) {
    const float abl = ab[e >> 1], amx = amax_s[r];
    if constexpr (PALLAS) return bf16r(abl - amx) + pylm_s[jl] - acc[4 * j + e];
    return BF16 ? bf16r(abl + pylm_s[jl]) - (acc[4 * j + e] + amx) : (abl - amx) + pylm_s[jl] - acc[4 * j + e];
  });
  flush(py, T, S1);
  stage([&](int j, int e, int jl, int r) {
    const float amx = amax_s[r];
    const float as = sym_s[jl] >= 0 ? ga[4 * j + e] : 0.f;
    const float v = PALLAS ? bf16r(as - amx) + pxlm_s[jl] - acc[4 * j + e]
                    : BF16 ? (as + pxlm_s[jl]) - (acc[4 * j + e] + amx)
                           : (as - amx) + pxlm_s[jl] - acc[4 * j + e];
    return (!modified && t0 + r == te) ? kNegInf : v;
  });
  flush(px, T1, S);
  // regular: the appended column t = T is -inf, written by the last t tile
  if (!modified && blockIdx.x == gridDim.x - 1)
    for (int s = n0 + tid; s < min(n0 + NCOL, S); s += kFwdThreads) px[((size_t)s * B + b) * T1 + T] = kNegInf;
}

template <bool BF16, bool PALLAS, int OP, int NB8>
int launch_fwd(const void* lm, const void* sym, const void* te, const void* am, const void* uni,
               int B, int S, int T, int C, int blank, int modified, float* side, void* img_hi,
               void* img_lo, void* px, void* py, void* nd, void* d_out, void* amax_out,
               void* duni_out, cudaStream_t st) {
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int kE = sizeof(Tin), KC = OP == 0 ? 64 : 32, kParts = OP == 2 ? 2 : 1;
  const int S1 = S + 1, G = image_groups(S1), nK = even_chunks(C, KC);
  float *lmmax = side, *pylm = side + (size_t)B * S1, *pxlm = side + 2 * (size_t)B * S1;
  lm_parts_kernel<BF16, PALLAS, OP><<<dim3((unsigned)(G * 8), (unsigned)B), 128, 0, st>>>(
      lm, static_cast<const int*>(sym), S, C, blank, nK, G, lmmax, pylm, pxlm, img_hi, img_lo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t ring = (size_t)kFwdStages * kParts * NB8 * 1024;
  const size_t misc = 4 * 8 * NB8 * 4 + 2 * 64 * 4 + 8 * 8;
  const size_t tile = (size_t)64 * C * kE;
  // the frames' rows are one contiguous range: one bulk copy where its start
  // and length are 16-byte multiples for every tile (T a multiple of
  // 16 / gcd(C kE, 16)), else the block's threads copy it
  int gc = 16;
  while ((C * kE) % gc != 0) gc /= 2;
  const int m = 16 / gc;
  const int am_mode = ring + misc + tile > 227 * 1024 ? kam_global
                      : reinterpret_cast<uintptr_t>(am) % 16 == 0 && T % m == 0 ? kam_bulk
                                                                                   : kam_threads;
  const size_t bytes = ring + misc + (am_mode != kam_global ? tile : 0);
  auto kern = latbuild_fwd_kernel<BF16, PALLAS, OP, NB8>;
  if ((err = allow_max_smem<latbuild_fwd_kernel<BF16, PALLAS, OP, NB8>>()) != cudaSuccess) return (int)err;
  const int t_tiles = (T + 63) / 64;
  const dim3 grid((unsigned)(t_tiles > 0 ? t_tiles : 1), (unsigned)(G / NB8), (unsigned)B);
  kern<<<grid, kFwdThreads, bytes, st>>>(
      img_hi, img_lo, pxlm, pylm, lmmax, static_cast<const int*>(sym), static_cast<const int*>(te), am,
      static_cast<const float*>(uni), B, S, T, C, blank, modified, G, nK, am_mode,
      static_cast<float*>(px), static_cast<float*>(py), static_cast<float*>(nd),
      static_cast<float*>(d_out), static_cast<float*>(amax_out), static_cast<float*>(duni_out));
  return (int)cudaGetLastError();
}

template <bool BF16, bool PALLAS, int OP>
int launch_fwd_nb8(const void* lm, const void* sym, const void* te, const void* am, const void* uni,
                   int B, int S, int T, int C, int blank, int modified, float* side, void* img_hi,
                   void* img_lo, void* px, void* py, void* nd, void* d_out, void* amax_out,
                   void* duni_out, cudaStream_t st) {
#define FRT_FWD(N)                                                                              \
  case N:                                                                                       \
    return launch_fwd<BF16, PALLAS, OP, N>(lm, sym, te, am, uni, B, S, T, C, blank, modified, side, \
                                       img_hi, img_lo, px, py, nd, d_out, amax_out, duni_out, st);
  switch (pick_nb8(S + 1)) {
    FRT_FWD(4)
    FRT_FWD(8)
    FRT_FWD(13)
    default:
      FRT_FWD(16)
  }
#undef FRT_FWD
}

}  // namespace

// lm (B, S+1, C) and am (B, T, C), both float32 or both bf16 (bf16 = 1);
// symbols (B, S) and te (B,) int32 (te = -1: no t_end column); uni (C,)
// f32 or NULL (plain build); bf16 with uni rounds as the Pallas smoothed
// build does.  prec, the operand mode of float32 inputs: 0 one bf16 pass,
// 1 one TF32 pass, 2 3xTF32 (bf16 inputs ignore it).  Scratch: side, 3 B
// (S+1) f32 (lmmax, pylm, pxlm), and img_hi, img_lo (float32 at prec 2
// only) of the sizes frt_latbuild_sizes gives.  Out: px (S, B, T or T+1),
// py (S+1, B, T) f32; nd (S+1, B, T) when uni is given; the residuals d
// (S+1, B, T), amax (B, T) and duni (B, T, smoothed only) where their
// pointers are not NULL.
extern "C" int frt_latbuild_fwd(const void* lm, const void* sym, const void* te, const void* am,
                                const void* uni, int B, int S, int T, int C, int blank,
                                int modified, int bf16, int prec, void* side, void* img_hi,
                                void* img_lo, void* px, void* py, void* nd, void* d_out,
                                void* amax_out, void* duni_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* sd = static_cast<float*>(side);
#define FRT_FWD_MODE(BF, PA, OP)                                                                 \
  return launch_fwd_nb8<BF, PA, OP>(lm, sym, te, am, uni, B, S, T, C, blank, modified, sd, img_hi, \
                                    img_lo, px, py, nd, d_out, amax_out, duni_out, st);
  if (bf16 && uni != nullptr) FRT_FWD_MODE(true, true, 0)
  if (bf16) FRT_FWD_MODE(true, false, 0)
  if (prec == 0) FRT_FWD_MODE(false, false, 0)
  if (prec == 1) FRT_FWD_MODE(false, false, 1)
  FRT_FWD_MODE(false, false, 2)
#undef FRT_FWD_MODE
}

// The forward's exp operands, for a check of its operand modes: out[r, c]
// = exp(x[r, c] - m[r]) as the products of float32 inputs take it in
// operand mode prec (rounded to bf16 or TF32 in modes 0 and 1), x (rows,
// cols) float32.
__global__ void round_exps_kernel(const float* __restrict__ x, const float* __restrict__ m, long rows,
                                  int cols, int prec, float* __restrict__ out) {
  const long n = rows * cols;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    const float a = x[i], mx = m[i / cols];
    out[i] = prec == 0   ? op_round<0>(operand_exp<false, false, 0>(a, mx))
             : prec == 1 ? op_round<1>(operand_exp<false, false, 1>(a, mx))
                         : operand_exp<false, false, 2>(a, mx);
  }
}

extern "C" int frt_round_exps(const void* x, const void* m, long long rows, int cols, int prec, void* out,
                              void* stream) {
  const long long n = rows * cols;
  if (n == 0) return 0;
  const long long blocks = (n + 255) / 256;
  round_exps_kernel<<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(m), rows, cols, prec, static_cast<float*>(out));
  return (int)cudaGetLastError();
}
