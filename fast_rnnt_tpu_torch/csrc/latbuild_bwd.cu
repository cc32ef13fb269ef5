// Backward of the simple-lattice build for Hopper (sm_90a): the VJP
// (lm, am, symbols, t_end, dpx, dpy [, dnd]) -> (d_lm, d_am [, d_uni]).
//
// Replaces the Pallas TPU kernel fast_rnnt_tpu/ops/kernels/latbuild.py
// _build_bwd_kernel, both variants: parts=False (:290, pallas_call :687,
// via _build_bwd :623 with the save_d residual) and parts=True (pallas_call
// :920, via _build_parts_bwd :884).
//
// With dpx' = dpx zeroed at t == T and, regular, at t == t_end:
//   w[s, t]      = (dnd[s, t] - dpx'[s, t] [s < S] - dpy[s, t]) / D[s, t]
//   d_am[t, c]   = amp[t, c] sum_s w[s, t] lmp[s, c]
//                + sum_s [sym_s == c] dpx'[s, t] + [c == blank] sum_s dpy[s, t]
//   d_lm[s, c]   = lmp[s, c] sum_t w[s, t] amp[t, c]
//                + [c == sym_s] sum_t dpx'[s, t] + [c == blank] sum_t dpy[s, t]
// with amp = exp(am - amax), lmp = exp(lm - lmmax) (the maxes are
// stop-gradient, as in the JAX package) and dnd = 0 for the plain build.
// The smoothed build adds one row S+1 to both products: lmp row S+1 = uni
// and w[S+1, t] = rd[t] = -sum_s dnd[s, t] / duni[t], so the d_am product
// yields the amp uni rd term with no extra code, and row S+1 of the d_lm
// product, before the lmp multiply, is the per-utterance d_uni partial
// sum_t rd[t] amp[t, c] (summed over b by the caller).  A symbol outside
// [0, C) contributes nothing, as in the forward.  bf16 inputs: amp and lmp
// are the forward's bf16 values, D the forward's float32 residual (the JAX
// package recomputes D in that mode; the port keeps the residual), and d_am
// is written in bf16; the plain build splits w into two bf16 parts
// (~2^-16), the smoothed build (PALLAS) rounds as the Pallas kernel's bf16
// mode does (:326-420): w and the one-hot term's dpx' to bf16, rd to bf16 in
// d_uni (its image has no lo part) but not in d_am (rd's row of the d_am
// operand keeps both parts), and d_am's factor amp is exp(am - amax) in
// float32, unrounded.
//
// The matmul precision (prec, frt_latbuild_bwd) reaches d_uni's product
// alone, as the Pallas kernel's precision argument does (:401): at 2 it is
// the d_lm product's row S+1; at 1 (one TF32 pass) and 0 (one bf16 pass) a
// kernel of its own takes it, rd and the exps rounded as such a pass
// rounds them.  The d_am and d_lm products are 3xTF32 at every level, as
// the Pallas kernel's fixed splits are, and D is the forward's residual.
//
// Design.  The Pallas kernel carries d_lm in VMEM across a sequential t
// grid; blocks here run in no order, so each output has exactly one owner
// block and no atomics are used (d_lm, d_uni and d_am are deterministic):
//   1. prep: one block per (64 frames, utterance), 256 threads, lanes on t
//      (every load coalesced), four s-slices per frame, in passes of up to
//      256 rows s (any S).  It forms w in a shared tile, then writes it
//      twice: for the d_am product's A operand per 64-frame tile and chunk
//      of s as one padded 64 x (KC + 4) block, and as the TF32 hi / lo (bf16
//      hi / lo) image of the d_lm product's B operand (wgmma.cuh).  Also the
//      column sums sum_s dpy (B, T) and one partial of the row sums
//      sum_t dpx', sum_t dpy per 32 frames (B, P, S+1): the prep's 97 us of
//      the earlier design (one thread per (b, t) walking s, per-warp
//      partials) went.
//   2. d_am: block (64 t, 128 c, b), K = s, on the tensor cores: A = w
//      (registers, split as it is loaded), B = the image of lmp^T (written
//      by image_kernel), a two-stage ring of bulk copies (two blocks per
//      SM).  While the last chunk's products run, the epilogue's am tile
//      comes by TMA into the stage just freed (by 4-byte cp.async copies
//      where am's rows are not 16-byte multiples, as bf16 rows of C = 500
//      are); the symbols that fall in the block's columns are listed (in s
//      order, up to 1,024 of them; past those the epilogue walks the rest)
//      and their cotangent rows staged by cp.async.  The epilogue stages the
//      tile, applies amp (the forward's amax residual, no amax pass) and the
//      blank column sum in one pass, adds the one-hot term from the list
//      (one thread per frame, in s order: no walk over all S symbols per
//      output), and writes d_am coalesced.
//   3. d_lm: block (64 c, one N tile of rows s, b), K = all of T: A =
//      exp(am - amax)^T built in registers from an am chunk that a TMA box
//      brings in (cp.async copies where am's rows are not 16-byte
//      multiples), once per chunk, B = the w image; the frame maxima come by
//      cp.async, each thread's completion an arrival on the stage's
//      mbarrier.  The epilogue adds the row sums for the one-hot and blank
//      terms, summed once per block.
//
// What bounds it.  Two products of 2 B T (S+1) C = 3.0 GFLOP each at the
// headline shape (B=30, T=1000, S=100, C=500), in three TF32 passes 18.3
// GFLOP (37 us at 495 TFLOP/s), against ~170 MB (am, D, dpx, dpy in; d_am
// out; w written and read twice): ~50 us at 3.35 TB/s.  The d_am product
// is 1,920 short blocks (four K chunks); its per-block set-up and epilogue
// outweigh its products.

#include <cuda.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"
#include "wgmma.cuh"

using namespace frt;

namespace {

constexpr int kPrepT = 64;  // frames per prep block
constexpr int kPrepS = 256;  // rows s of a prep pass (its shared tile: 64 KB)
constexpr int kTileC = 128;  // columns c of a d_am block (16 groups: one N tile)
constexpr int kStageLd = kTileC + 1;  // row stride of the d_am epilogue's staging tile
constexpr int kAmStages = 2, kLmStages = 3;
constexpr int kDpxRows = 64;  // symbols of a d_am block whose cotangent rows are staged
constexpr int kListMax = 1024;  // symbols a d_am block lists (past them, it walks the rest)

template <bool BF16, bool PALLAS>
__global__ void __launch_bounds__(256)
latbuild_bwd_prep_kernel(const float* __restrict__ d, const float* __restrict__ duni,
                         const float* __restrict__ dpx, const float* __restrict__ dpy,
                         const float* __restrict__ dnd, const int* __restrict__ te_arr, int B,
                         int S, int T, int modified, int Sp, int Sc, int Gw, int nKt,
                         float* __restrict__ wT, void* __restrict__ wimg_hi,
                         void* __restrict__ wimg_lo, float* __restrict__ colsum,
                         float* __restrict__ rsx, float* __restrict__ rsy, float* __restrict__ rd) {
  using Tw = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int epc = 16 / sizeof(Tw), KC = 128 / sizeof(Tw);
  constexpr int AS = KC + 4;
  extern __shared__ float ws[];  // [kPrepT][Sc]: rows [s0, s0 + Sc) of one pass
  __shared__ float red[2][4][kPrepT];
  const int b = blockIdx.y, t0 = blockIdx.x * kPrepT;
  const int tid = threadIdx.x, tl = tid & (kPrepT - 1), sl = tid / kPrepT, lane = tid & 31;
  const int t = t0 + tl;
  const int S1 = S + 1, S1x = S1 + (dnd != nullptr);
  const int T1 = modified ? T : T + 1;
  const bool live = t < T;
  const bool px_live = live && (modified || t != te_arr[b]);
  const int P = gridDim.x * 2, part = blockIdx.x * 2 + tl / 32;
  float* wT_b = wT + ((size_t)b * gridDim.x + blockIdx.x) * (Sp / KC) * kPrepT * AS;
  const int per_chunk = Gw * 8 * KC;
  const int n_l = blockIdx.x == gridDim.x - 1 ? nKt - t0 / KC : kPrepT / KC;
  float cs = 0.f, ns = 0.f;
  // passes over the rows s, Sc (a multiple of KC) at a time, so that any S
  // fits; the last pass holds row S+1, the smoothed build's rd row
  for (int s0 = 0; s0 < Sp; s0 += Sc) {
    const int n = min(Sc, Sp - s0);
    const bool last = s0 + n == Sp;
    if (s0 > 0) __syncthreads();  // the previous pass has read the tile
    for (int j = sl; j < n; j += 4) {
      const int s = s0 + j;
      float wv = 0.f;
      if (s < S1) {
        const size_t o = ((size_t)s * B + b) * T + t;
        float dx = 0.f, dy = 0.f, dn = 0.f;
        if (live) {
          dy = dpy[o];
          if (s < S && px_live) dx = dpx[((size_t)s * B + b) * T1 + t];
          if (dnd != nullptr) dn = dnd[o];
          wv = (dn - (dx + dy)) / d[o];
          cs += dy;
          ns += dn;
        }
        const float rx = warp_sum(dx), ry = warp_sum(dy);
        if (lane == 0) {
          rsx[((size_t)b * P + part) * S1 + s] = rx;
          rsy[((size_t)b * P + part) * S1 + s] = ry;
        }
      }
      ws[tl * Sc + j] = PALLAS ? bf16r(wv) : wv;
    }
    // rd's sum: thread sl of a frame has added the rows s = sl (mod 4) in
    // increasing s; the four partials go ((p0 + p1) + p2) + p3 (the order
    // of ops/kernels/latbuild.py's unigram_weight_kernel_order)
    if (last) {
      red[0][sl][tl] = cs;
      red[1][sl][tl] = ns;
      __syncthreads();
      if (sl == 0 && live) {
        colsum[(size_t)b * T + t] = red[0][0][tl] + red[0][1][tl] + red[0][2][tl] + red[0][3][tl];
        if (dnd != nullptr) {
          const float r = -(red[1][0][tl] + red[1][1][tl] + red[1][2][tl] + red[1][3][tl]) /
                          duni[(size_t)b * T + t];
          ws[tl * Sc + S1 - s0] = r;
          if (rd != nullptr) rd[(size_t)b * T + t] = r;
        }
      }
    }
    __syncthreads();
    // w, t-major, for the d_am product's A operand: per chunk of KC rows s, a
    // 64 x (KC + 4) tile (the padding keeps its fragment loads on 32 banks),
    // one bulk copy each
    float* wT_p = wT_b + (size_t)(s0 / KC) * kPrepT * AS;
    for (int i = tid; i < n / KC * kPrepT * AS; i += 256) {
      const int col = i % AS, r = (i / AS) % kPrepT, ks = i / (AS * kPrepT);
      wT_p[i] = (col < KC && t0 + r < T) ? ws[r * Sc + ks * KC + col] : 0.f;
    }
    // the image chunks of frames [t0, t0 + kPrepT) (rows s, K = t), and the
    // last block's the zero chunks up to nKt: this pass's 8-row groups (the
    // last pass also the zero groups past Sp)
    const int g0 = s0 / 8, g1 = last ? Gw : min(Gw, (s0 + n) / 8);
    for (int l = 0; l < n_l; ++l) {
      const int kc = t0 / KC + l;
      const size_t base = ((size_t)b * nKt + kc) * per_chunk;
      for (int i = g0 * 8 * KC + tid; i < g1 * 8 * KC; i += 256) {
        const int e = i % epc, r8 = (i / epc) % 8, cm = (i / (epc * 8)) % (KC / epc);
        const int gg = i / (8 * KC);
        const int s = gg * 8 + r8, tt = l * KC + cm * epc + e;
        const float v = (s < S1x && tt < kPrepT && t0 + tt < T) ? ws[tt * Sc + s - s0] : 0.f;
        if constexpr (BF16) {
          const __nv_bfloat16 h = __float2bfloat16_rn(v);
          static_cast<__nv_bfloat16*>(wimg_hi)[base + i] = h;
          static_cast<__nv_bfloat16*>(wimg_lo)[base + i] = __float2bfloat16_rn(PALLAS ? 0.f : v - __bfloat162float(h));
        } else {
          uint32_t h, lo;
          split_tf32(v, h, lo);
          static_cast<uint32_t*>(wimg_hi)[base + i] = h;
          static_cast<uint32_t*>(wimg_lo)[base + i] = lo;
        }
      }
    }
  }
}

// How a kernel brings am tiles into shared memory: kam_tma (one TMA box),
// kam_async (4-byte cp.async copies by every thread: rows not 16-byte
// multiples), kam_global (odd bf16 vocabularies: the kernel reads device
// memory)
enum { kam_tma = 0, kam_async = 1, kam_global = 2 };

// d_am: rows t, columns c, K = the S1x rows of w and lmp.
template <bool BF16, bool PALLAS>
__global__ void __launch_bounds__(128)
latbuild_bwd_am_kernel(const float* __restrict__ wT, const void* __restrict__ limg_hi,
                       const void* __restrict__ limg_lo, const int* __restrict__ sym,
                       const int* __restrict__ te_arr, const void* __restrict__ am_v,
                       const float* __restrict__ amax, const float* __restrict__ colsum,
                       const float* __restrict__ dpx, int B, int S, int T, int C, int blank,
                       int modified, int nKs, int Gc, int am_mode,
                       const __grid_constant__ CUtensorMap am_map, void* __restrict__ d_am_v) {
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int kParts = BF16 ? 1 : 2;
  constexpr int KC = BF16 ? 64 : 32, KSTEP = BF16 ? 16 : 8;
  constexpr int AS = KC + 4;  // A tile row stride (floats): 4 mod 32 words
  constexpr int kABytes = 64 * AS * 4;
  constexpr uint32_t kPart = kTileC / 8 * 1024;
  constexpr int kStageBytes = kABytes + kParts * kPart;
  extern __shared__ __align__(128) unsigned char smem[];
  float* amx_s = reinterpret_cast<float*>(smem + kAmStages * kStageBytes);  // amax, 64 frames
  float* cs_s = amx_s + 64;                                                   // colsum
  uint64_t* bars = reinterpret_cast<uint64_t*>(cs_s + 64);  // the stages', then the am tile's
  int* nsym_s = reinterpret_cast<int*>(bars + kAmStages + 1);
  int* list = nsym_s + 4;  // (s, column - c0) of the block's symbols, in s order
  int* list_c = list + min(S, kListMax);
  // the cotangent rows dpx'[s, t0 .. t0 + 63] of the first kDpxRows of them
  float* dpx_s = reinterpret_cast<float*>(list_c + min(S, kListMax));

  const int t0 = blockIdx.x * 64, c0 = blockIdx.y * kTileC, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int T1 = modified ? T : T + 1;
  const int nrows = min(64, T - t0);
  const float* wT_b = wT + ((size_t)b * gridDim.x + blockIdx.x) * nKs * 64 * AS;
  const Tin* am_b = static_cast<const Tin*>(am_v) + (size_t)b * T * C;
  const size_t img_off = ((size_t)b * nKs * Gc + c0 / 8) * 1024;
  const unsigned char* hi_b = static_cast<const unsigned char*>(limg_hi) + img_off;
  const unsigned char* lo_b = BF16 ? nullptr : static_cast<const unsigned char*>(limg_lo) + img_off;

  auto issue = [&](int k) {  // warp 0
    unsigned char* dst = smem + (k % kAmStages) * kStageBytes;
    uint64_t* bar = &bars[k % kAmStages];
    if (lane == 0) {
      mbar_expect_tx(bar, kABytes + kParts * kPart);
      bulk_copy(dst, wT_b + (size_t)k * 64 * AS, kABytes, bar);
      bulk_copy(dst + kABytes, hi_b + (size_t)k * Gc * 1024, kPart, bar);
      if constexpr (!BF16) bulk_copy(dst + kABytes + kPart, lo_b + (size_t)k * Gc * 1024, kPart, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kAmStages; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0) {
    for (int k = 0; k < min(kAmStages, nKs); ++k) issue(k);
  } else if (warp == 1) {
    // the symbols whose column falls in this block, in s order, up to
    // kListMax of them (from s_stop on, the epilogue walks the symbols)
    int n = 0, s_stop = S;
    const int c_end = min(C, c0 + kTileC);
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + lane;
      const int sy = s < S ? sym[(size_t)b * S + s] : -1;
      const bool in = sy >= c0 && sy < c_end;
      const unsigned m = __ballot_sync(0xffffffffu, in);
      if (n + __popc(m) > kListMax) {
        s_stop = s0;
        break;
      }
      if (in) {
        list[n + __popc(m & ((1u << lane) - 1))] = s;
        list_c[n + __popc(m & ((1u << lane) - 1))] = sy - c0;
      }
      n += __popc(m);
    }
    if (lane == 0) {
      nsym_s[0] = n;
      nsym_s[1] = s_stop;
    }
    __syncwarp();
    // and their cotangent rows (64 frames each, zero where dpx' is: past T,
    // and at t_end for the regular lattice) into shared memory
    const int te = modified ? -1 : te_arr[b];
    for (int i = lane; i < min(n, kDpxRows) * 64; i += 32) {
      const int e = i >> 6, r = i & 63;
      const bool ok = r < nrows && t0 + r != te;
      cp_async4(dpx_s + i, ok ? dpx + ((size_t)list[e] * B + b) * T1 + t0 + r : dpx, ok);
    }
    cp_async_commit();
  } else if (warp == 2) {
    for (int r = lane; r < 64; r += 32) {
      amx_s[r] = r < nrows ? amax[(size_t)b * T + t0 + r] : 0.f;
      cs_s[r] = r < nrows ? colsum[(size_t)b * T + t0 + r] : 0.f;
    }
  }

  // the epilogue's am rows into L2 while the products run
  {
    constexpr int kLine = 128 / sizeof(Tin);  // elements per 128-byte line
    for (int li = tid; li < 64 * (kTileC / kLine); li += 128) {
      const int r = li / (kTileC / kLine), c = c0 + (li % (kTileC / kLine)) * kLine;
      if (r < nrows && c < C) prefetch_l2(am_b + (size_t)(t0 + r) * C + c);
    }
  }
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  float acc[4 * (kTileC / 8)];
#pragma unroll
  for (int i = 0; i < 4 * (kTileC / 8); ++i) acc[i] = 0.f;
  mainloop<BF16, true, !BF16, kTileC / 8>(
      acc, nKs, kPart,
      [&](int k) { mbar_wait(&bars[k % kAmStages], (k / kAmStages) & 1); },
      [&](int k, uint32_t(&h)[4][4], uint32_t(&l)[4][4]) {
        // rows past nrows hold zeros (the prep writes whole tiles)
        const float* At = reinterpret_cast<const float*>(smem + (k % kAmStages) * kStageBytes);
        constexpr int kCols = BF16 ? 4 : 2;
        float w0[4][kCols], w1[4][kCols];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            const int col = ks * KSTEP + (BF16 ? 2 * q + (i & 1) + 8 * (i >> 1) : q + 4 * i);
            w0[ks][i] = At[r0 * AS + col];
            w1[ks][i] = At[r1 * AS + col];
          }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          if constexpr (BF16) {
            split_bf16x2(w0[ks][0], w0[ks][1], h[ks][0], l[ks][0]);
            split_bf16x2(w1[ks][0], w1[ks][1], h[ks][1], l[ks][1]);
            split_bf16x2(w0[ks][2], w0[ks][3], h[ks][2], l[ks][2]);
            split_bf16x2(w1[ks][2], w1[ks][3], h[ks][3], l[ks][3]);
          } else {
            split_tf32(w0[ks][0], h[ks][0], l[ks][0]);
            split_tf32(w1[ks][0], h[ks][1], l[ks][1]);
            split_tf32(w0[ks][1], h[ks][2], l[ks][2]);
            split_tf32(w1[ks][1], h[ks][3], l[ks][3]);
          }
        }
      },
      [&](int k) { return smem_u32(smem + (k % kAmStages) * kStageBytes + kABytes); },
      [&](int k) {
        __syncthreads();
        if (warp == 0 && k + kAmStages < nKs) issue(k + kAmStages);
        // the last chunk's products run: the epilogue's am tile, 64 frames
        // x kTileC columns (zeros past C and T), into the stage just freed
        if (k == nKs - 2) {
          unsigned char* dst = smem + (k % kAmStages) * kStageBytes;
          if (am_mode == kam_tma && tid == 0) {
            mbar_expect_tx(&bars[kAmStages], 64 * kTileC * sizeof(Tin));
            tma_load_2d(dst, &am_map, c0, b * T + t0, &bars[kAmStages]);
          } else if (am_mode == kam_async) {
            constexpr int kPer = 4 / sizeof(Tin);  // elements per 4-byte copy
            for (int i = tid; i < 64 * kTileC / kPer; i += 128) {
              const int r = i / (kTileC / kPer), cl = (i % (kTileC / kPer)) * kPer;
              const bool ok = r < nrows && c0 + cl < C;
              cp_async4(dst + (r * kTileC + cl) * sizeof(Tin), ok ? am_b + (size_t)(t0 + r) * C + c0 + cl : am_b,
                        ok);
            }
            cp_async_commit();
          }
        }
      });

  // the cotangent rows (and, kam_async, the am tile): visible after the
  // barrier below
  if (warp == 1 || am_mode == kam_async) cp_async_wait<0>();
  // epilogue: the last chunk's stage is free, stage the tile there (nKs is
  // even: the am tile is in stage 0, this is stage 1)
  float* stg = reinterpret_cast<float*>(smem + kStageBytes);
#pragma unroll
  for (int j = 0; j < kTileC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      stg[(e < 2 ? r0 : r1) * kStageLd + 8 * j + 2 * q + (e & 1)] = acc[4 * j + e];
  __syncthreads();
  // d_am = amp * product + the blank column sum, eight elements a thread at
  // a time (their loads in flight together), back into the staged tile
  const Tin* am_tile = reinterpret_cast<const Tin*>(smem);
  if (am_mode == kam_tma) mbar_wait(&bars[kAmStages], 0);
  for (int i0 = tid; i0 < 64 * kTileC; i0 += 128 * 8) {
    float a[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 128 * u, r = i / kTileC, c = c0 + i % kTileC;
      a[u] = am_mode != kam_global ? ld_f(am_tile + i)
                                   : (r < nrows && c < C) ? ld_f(am_b + (size_t)(t0 + r) * C + c) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int i = i0 + 128 * u, r = i / kTileC, cl = i % kTileC;
      const float mx = amx_s[r];
      const float ap = PALLAS ? expf(a[u] - mx) : shifted_exp<BF16>(a[u], mx);
      float v = ap * stg[r * kStageLd + cl];
      if (c0 + cl == blank) v += cs_s[r];
      stg[r * kStageLd + cl] = v;
    }
  }
  __syncthreads();
  // + the one-hot term: one thread per frame, the block's symbols in s order
  // (their cotangent rows staged in shared memory)
  if (tid < nrows) {
    const int t = t0 + tid, te = modified ? -1 : te_arr[b], n = nsym_s[0];
    float* row = stg + tid * kStageLd;
    auto g = [](float v) { return PALLAS ? bf16r(v) : v; };
    for (int i = 0; i < n; ++i)
      row[list_c[i]] +=
          g(i < kDpxRows ? dpx_s[i * 64 + tid] : (t != te ? dpx[((size_t)list[i] * B + b) * T1 + t] : 0.f));
    for (int s = nsym_s[1]; s < S; ++s) {  // past a full list
      const int sy = sym[(size_t)b * S + s];
      if (sy >= c0 && sy < min(C, c0 + kTileC) && t != te) row[sy - c0] += g(dpx[((size_t)s * B + b) * T1 + t]);
    }
  }
  __syncthreads();
  Tin* d_am = static_cast<Tin*>(d_am_v) + (size_t)b * T * C;
  for (int i = tid; i < 64 * kTileC; i += 128) {
    const int r = i / kTileC, cl = i % kTileC, c = c0 + cl;
    if (r >= nrows || c >= C) continue;
    const float v = stg[r * kStageLd + cl];
    if constexpr (BF16)
      d_am[(size_t)(t0 + r) * C + c] = __float2bfloat16_rn(v);
    else
      d_am[(size_t)(t0 + r) * C + c] = v;
  }
}

// d_lm (and the d_uni partial): rows c, columns s, K = all T frames.

template <bool BF16, bool PALLAS, int NB8>
__global__ void __launch_bounds__(128)
latbuild_bwd_lm_kernel(const void* __restrict__ lmp_v, const int* __restrict__ sym,
                       const void* __restrict__ am_v, const float* __restrict__ amax,
                       const void* __restrict__ wimg_hi, const void* __restrict__ wimg_lo,
                       const float* __restrict__ rsx, const float* __restrict__ rsy, int P, int S,
                       int S1x, int T, int C, int blank, int Gw, int nKt, int am_mode,
                       const __grid_constant__ CUtensorMap am_map, float* __restrict__ d_lm,
                       float* __restrict__ duni_part) {
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int kE = sizeof(Tin);
  constexpr int KC = 128 / kE, KSTEP = 32 / kE;
  constexpr int AS = 72;  // am chunk row (the TMA box's width): 8 mod 32 words (f32)
  constexpr int kABytes = KC * AS * kE;
  constexpr int kMBytes = KC * 4;  // the chunk's frame maxima
  constexpr uint32_t kPart = NB8 * 1024;
  constexpr int kStageBytes = kABytes + kMBytes + 2 * kPart;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kLmStages * kStageBytes);
  int* side_sym = reinterpret_cast<int*>(bars + kLmStages + 1);
  float* side_gx = reinterpret_cast<float*>(side_sym + 8 * NB8);
  float* side_gy = side_gx + 8 * NB8;

  const int c0 = blockIdx.x * 64, n0 = blockIdx.y * 8 * NB8, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, q = lane & 3;
  const int S1 = S + 1;
  const int ncol = min(64, C - c0);
  const Tin* am_b = static_cast<const Tin*>(am_v) + (size_t)b * T * C;
  const float* amax_b = amax + (size_t)b * T;
  const size_t img_off = ((size_t)b * nKt * Gw + n0 / 8) * 1024;
  const unsigned char* hi_b = static_cast<const unsigned char*>(wimg_hi) + img_off;
  const unsigned char* lo_b = static_cast<const unsigned char*>(wimg_lo) + img_off;
  auto stage = [&](int k) { return smem + (k % kLmStages) * kStageBytes; };

  // chunk k's B images (and, kam_tma, its am box) on the stage's mbarrier
  auto issue_b = [&](int k) {  // one thread
    unsigned char* dst = stage(k);
    uint64_t* bar = &bars[k % kLmStages];
    mbar_expect_tx(bar, (am_mode == kam_tma ? kABytes : 0) + 2 * kPart);
    // the am box: KC frames from k KC on (the next utterance's, or zeros,
    // past T: masked), AS columns from c0 on (zeros past C)
    if (am_mode == kam_tma) tma_load_2d(dst, &am_map, c0, b * T + k * KC, bar);
    bulk_copy(dst + kABytes + kMBytes, hi_b + (size_t)k * Gw * 1024, kPart, bar);
    bulk_copy(dst + kABytes + kMBytes + kPart, lo_b + (size_t)k * Gw * 1024, kPart, bar);
  };
  // chunk k's frame maxima (and, kam_async, its am tile) by every thread
  // with cp.async, each thread's completion an arrival on the stage's
  // barrier (which expects 128 of them besides the copies' bytes)
  auto issue_a = [&](int k) {
    unsigned char* dst = stage(k);
    const int tb = k * KC;
    for (int i = tid; i < KC; i += 128)
      cp_async4(dst + kABytes + 4 * i, amax_b + min(tb + i, T - 1), tb + i < T);
    if (am_mode == kam_async) {
      constexpr int kPer = 4 / kE;  // elements per 4-byte copy
      for (int i = tid; i < KC * 64 / kPer; i += 128) {
        const int tl = i / (64 / kPer), cl = (i % (64 / kPer)) * kPer;
        const bool ok = tb + tl < T && c0 + cl < C;
        cp_async4(dst + (tl * AS + cl) * kE, ok ? am_b + (size_t)(tb + tl) * C + c0 + cl : am_b, ok);
      }
    }
    cp_async_arrive(&bars[k % kLmStages]);
  };
  if (tid == 0) {
    for (int i = 0; i < kLmStages; ++i) mbar_init(&bars[i], 1 + 128);
    mbar_fence_init();
  }
  // the block's rows s: symbols and the row sums over t of dpx' and dpy
  for (int jl = tid; jl < 8 * NB8; jl += 128) {
    const int s = n0 + jl;
    float gx = 0.f, gy = 0.f;
    if (s < S1)
      for (int p = 0; p < P; ++p) {
        gx += rsx[((size_t)b * P + p) * S1 + s];
        gy += rsy[((size_t)b * P + p) * S1 + s];
      }
    side_sym[jl] = s < S ? sym[(size_t)b * S + s] : -1;
    side_gx[jl] = gx;
    side_gy[jl] = gy;
  }
  __syncthreads();
  for (int k = 0; k < min(kLmStages, nKt); ++k) {
    if (tid == 0) issue_b(k);
    issue_a(k);
  }
  // the epilogue's lmp rows into L2 while the products run
  for (int li = tid; li < 8 * NB8; li += 128)
    if (n0 + li < S1x && ncol > 0) {
      const Tin* row = static_cast<const Tin*>(lmp_v) + ((size_t)b * S1x + n0 + li) * C + c0;
      prefetch_l2(row);
      prefetch_l2(row + ncol - 1);
    }

  const int r0 = 16 * warp + g, r1 = r0 + 8;  // c = c0 + r
  const bool v0 = r0 < ncol, v1 = r1 < ncol;
  float acc[4 * NB8];
#pragma unroll
  for (int i = 0; i < 4 * NB8; ++i) acc[i] = 0.f;
  mainloop<BF16, !BF16, true, NB8>(
      acc, nKt, kPart,
      [&](int k) { mbar_wait(&bars[k % kLmStages], (k / kLmStages) & 1); },
      [&](int k, uint32_t(&h)[4][4], uint32_t(&l)[4][4]) {
        // every load first (frames past T and columns past C read zeros or
        // a clamped element, and are zeroed), then the exps and splits
        const Tin* At = reinterpret_cast<const Tin*>(stage(k));
        const float* mx_s = reinterpret_cast<const float*>(stage(k) + kABytes);
        const int tb = k * KC;
        constexpr int kCols = BF16 ? 4 : 2;  // frames per row in a k-step
        float a0[4][kCols], a1[4][kCols], mx[4][kCols];
        int tt[4][kCols];
#pragma unroll
        for (int ks = 0; ks < 4; ++ks)
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            const int tl = ks * KSTEP + (BF16 ? 2 * q + (i & 1) + 8 * (i >> 1) : q + 4 * i);
            tt[ks][i] = tb + tl;
            mx[ks][i] = mx_s[tl];
            if (am_mode != kam_global) {
              a0[ks][i] = ld_f(At + tl * AS + r0);
              a1[ks][i] = ld_f(At + tl * AS + r1);
            } else {
              const Tin* row = am_b + (size_t)min(tb + tl, T - 1) * C + c0;
              a0[ks][i] = ld_f(row + min(r0, ncol - 1));
              a1[ks][i] = ld_f(row + min(r1, ncol - 1));
            }
          }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          float e0[kCols], e1[kCols];
#pragma unroll
          for (int i = 0; i < kCols; ++i) {
            const bool tok = tt[ks][i] < T;
            e0[i] = shifted_exp<BF16, PALLAS>(a0[ks][i], mx[ks][i]);
            e1[i] = shifted_exp<BF16, PALLAS>(a1[ks][i], mx[ks][i]);
            e0[i] = v0 && tok ? e0[i] : 0.f;
            e1[i] = v1 && tok ? e1[i] : 0.f;
          }
          if constexpr (BF16) {
            h[ks][0] = pack_bf16(e0[0], e0[1]);
            h[ks][1] = pack_bf16(e1[0], e1[1]);
            h[ks][2] = pack_bf16(e0[2], e0[3]);
            h[ks][3] = pack_bf16(e1[2], e1[3]);
          } else {
            split_tf32(e0[0], h[ks][0], l[ks][0]);
            split_tf32(e1[0], h[ks][1], l[ks][1]);
            split_tf32(e0[1], h[ks][2], l[ks][2]);
            split_tf32(e1[1], h[ks][3], l[ks][3]);
          }
        }
      },
      [&](int k) { return smem_u32(stage(k) + kABytes + kMBytes); },
      [&](int k) {
        __syncthreads();  // chunk k is consumed: refill its stage
        if (k + kLmStages < nKt) {
          if (tid == 0) issue_b(k + kLmStages);
          issue_a(k + kLmStages);
        }
      });

  // epilogue: the lmp loads first, then the stores
  const Tin* lmp_b = static_cast<const Tin*>(lmp_v) + (size_t)b * S1x * C;
  float lp[4 * NB8];
#pragma unroll
  for (int j = 0; j < NB8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1;
      const int s = min(n0 + 8 * j + 2 * q + (e & 1), S1x - 1);
      lp[4 * j + e] = ld_f(lmp_b + (size_t)s * C + c0 + min(r, max(ncol - 1, 0)));
    }
#pragma unroll
  for (int j = 0; j < NB8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e < 2 ? r0 : r1, c = c0 + r;
      const int jl = 8 * j + 2 * q + (e & 1), s = n0 + jl;
      if (r >= ncol || s >= S1x) continue;
      if (s == S1) {  // the smoothed build's unigram row: the d_uni partial
        if (duni_part != nullptr) duni_part[(size_t)b * C + c] = acc[4 * j + e];
        continue;
      }
      float v = lp[4 * j + e] * acc[4 * j + e];
      if (side_sym[jl] == c) v += side_gx[jl];
      if (c == blank) v += side_gy[jl];
      d_lm[((size_t)b * S1 + s) * C + c] = v;
    }
  }
}

// d_uni's product in one TF32 (OP 1) or bf16 (OP 0) pass, float32 inputs:
// duni_part[b, c] = sum_t op(rd[t]) op(exp(am[t, c] - amax[t])), each
// operand rounded as such a pass rounds it (the exps as the forward's duni
// takes them), the products exact in float32.  A block per (32 columns,
// utterance), its 8 warps each over every 8th frame, the 8 partials summed
// in a fixed order.
template <int OP>
__global__ void __launch_bounds__(256)
latbuild_bwd_duni_kernel(const float* __restrict__ am, const float* __restrict__ amax,
                         const float* __restrict__ rd, int T, int C, float* __restrict__ duni_part) {
  __shared__ float part[8][32];
  const int b = blockIdx.y, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  const float* am_b = am + (size_t)b * T * C;
  const float* mx = amax + (size_t)b * T;
  const float* r = rd + (size_t)b * T;
  float acc = 0.f;
  if (c < C) {
#pragma unroll 4
    for (int t = w; t < T; t += 8)
      acc = fmaf(op_round<OP>(r[t]), op_round<OP>(expf(am_b[(size_t)t * C + c] - mx[t])), acc);
  }
  part[w][lane] = acc;
  __syncthreads();
  if (w == 0 && c < C) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) v += part[i][lane];
    duni_part[(size_t)b * C + c] = v;
  }
}

// A 2D tensor map over am as (rows, C) with a (box_x columns, box_y rows)
// box, zero fill out of bounds.  cuTensorMapEncodeTiled is a driver-API
// call: it is taken through cudaGetDriverEntryPoint, so the library links
// against the runtime only.  Returns 0 (and the kernel reads am from
// device memory instead) where TMA cannot take am: rows not a multiple of
// 16 bytes, a misaligned base, or no entry point.
int am_tensor_map(CUtensorMap* map, const void* am, int rows, int C, bool bf16, int box_x, int box_y) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                              CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  const int esize = bf16 ? 2 : 4;
  if ((C * esize) % 16 != 0 || reinterpret_cast<uintptr_t>(am) % 16 != 0 || rows == 0) return 0;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess || fn == nullptr) {
      cudaGetLastError();
      return 0;
    }
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)C, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)C * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_x, (cuuint32_t)box_y};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<void*>(am), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// scratch sizes of the build backward (and the forward's lmp image); see
// frt_latbuild_sizes
struct Sizes {
  int KC, S1x, nKs, Sp, Gw, nKt, Gc, tiles, P;
  Sizes(int S, int T, int C, int bf16, int smoothed) {
    KC = bf16 ? 64 : 32;
    S1x = S + 1 + smoothed;
    nKs = even_chunks(S1x, KC);
    Sp = nKs * KC;
    Gw = image_groups(S1x);
    nKt = even_chunks(T, KC);
    Gc = (C + kTileC - 1) / kTileC * (kTileC / 8);
    tiles = (T + kPrepT - 1) / kPrepT;
    P = 2 * tiles;
  }
};

template <bool BF16, bool PALLAS, int NB8>
cudaError_t launch_lm(const void* lmp, const void* sym, const void* am, const void* amax,
                      void* wimg_hi, void* wimg_lo, const void* rsx, const void* rsy, const Sizes& z,
                      int B, int S, int T, int C, int blank, void* d_lm, void* duni_part,
                      cudaStream_t st) {
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int kE = sizeof(Tin), KC = 128 / kE;
  const size_t smem =
      (size_t)kLmStages * (KC * 72 * kE + KC * 4 + 2 * NB8 * 1024) + 8 * (kLmStages + 1) + 3 * 4 * 8 * NB8;
  cudaError_t err = allow_max_smem<latbuild_bwd_lm_kernel<BF16, PALLAS, NB8>>();
  if (err != cudaSuccess) return err;
  CUtensorMap map{};
  const int am_mode = am_tensor_map(&map, am, B * T, C, BF16, 72, KC) ? kam_tma
                      : (C * kE) % 4 == 0 && reinterpret_cast<uintptr_t>(am) % 4 == 0 ? kam_async
                                                                                       : kam_global;
  latbuild_bwd_lm_kernel<BF16, PALLAS, NB8><<<dim3((unsigned)((C + 63) / 64), (unsigned)(z.Gw / NB8),
                                                   (unsigned)B),
                                              128, smem, st>>>(
      lmp, static_cast<const int*>(sym), am, static_cast<const float*>(amax), wimg_hi, wimg_lo,
      static_cast<const float*>(rsx), static_cast<const float*>(rsy), z.P, S, z.S1x, T, C, blank,
      z.Gw, z.nKt, am_mode, map, static_cast<float*>(d_lm), static_cast<float*>(duni_part));
  return cudaGetLastError();
}

template <bool BF16, bool PALLAS>
int launch_bwd(const void* lmp, const void* sym, const void* te, const void* am, const void* amax,
               const void* d, const void* duni, const void* dpx, const void* dpy, const void* dnd,
               int B, int S, int T, int C, int blank, int modified, int prec, void* wT, void* wimg_hi,
               void* wimg_lo, void* limg_hi, void* limg_lo, void* colsum, void* rsx, void* rsy,
               void* rd, void* d_am, void* d_lm, void* duni_part, cudaStream_t st) {
  // d_uni in a one-pass mode: its own kernel, after the d_lm product
  const bool own_duni = !BF16 && dnd != nullptr && prec < 2;
  if (own_duni && rd == nullptr) return (int)cudaErrorInvalidValue;
  using Tin = std::conditional_t<BF16, __nv_bfloat16, float>;
  constexpr int kParts = BF16 ? 1 : 2;
  const Sizes z(S, T, C, BF16, dnd != nullptr);
  const int t_tiles = (T + kPrepT - 1) / kPrepT;
  cudaError_t err = launch_image<Tin>(static_cast<const Tin*>(lmp), (long)z.S1x * C, 1, C, B, C,
                                      z.S1x, z.KC, z.nKs, z.Gc, limg_hi, BF16 ? nullptr : limg_lo, st);
  if (err != cudaSuccess) return (int)err;

  const int Sc = std::min(z.Sp, kPrepS);
  if ((err = allow_max_smem<latbuild_bwd_prep_kernel<BF16, PALLAS>>()) != cudaSuccess) return (int)err;
  latbuild_bwd_prep_kernel<BF16, PALLAS><<<dim3((unsigned)t_tiles, (unsigned)B), 256, (size_t)kPrepT * Sc * 4,
                                   st>>>(
      static_cast<const float*>(d), static_cast<const float*>(duni), static_cast<const float*>(dpx),
      static_cast<const float*>(dpy), static_cast<const float*>(dnd), static_cast<const int*>(te), B,
      S, T, modified, z.Sp, Sc, z.Gw, z.nKt, static_cast<float*>(wT), wimg_hi, wimg_lo,
      static_cast<float*>(colsum), static_cast<float*>(rsx), static_cast<float*>(rsy),
      static_cast<float*>(rd));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  constexpr int kAmStage = 64 * ((BF16 ? 64 : 32) + 4) * 4 + kParts * kTileC / 8 * 1024;
  const size_t am_smem =
      (size_t)kAmStages * kAmStage + 2 * 64 * 4 + 8 * (kAmStages + 1) + 16 + 2 * 4 * std::min(S, kListMax) +
      (size_t)std::min(S, kDpxRows) * 64 * 4;
  if ((err = allow_max_smem<latbuild_bwd_am_kernel<BF16, PALLAS>>()) != cudaSuccess) return (int)err;
  CUtensorMap tile_map{};
  const int am_mode = am_tensor_map(&tile_map, am, B * T, C, BF16, kTileC, 64)             ? kam_tma
                      : (C * sizeof(Tin)) % 4 == 0 && reinterpret_cast<uintptr_t>(am) % 4 == 0 ? kam_async
                                                                                             : kam_global;
  latbuild_bwd_am_kernel<BF16, PALLAS><<<dim3((unsigned)t_tiles, (unsigned)(z.Gc / (kTileC / 8)), (unsigned)B),
                                 128, am_smem, st>>>(
      static_cast<const float*>(wT), limg_hi, limg_lo, static_cast<const int*>(sym),
      static_cast<const int*>(te), am, static_cast<const float*>(amax),
      static_cast<const float*>(colsum), static_cast<const float*>(dpx), B, S, T, C, blank,
      modified, z.nKs, z.Gc, am_mode, tile_map, d_am);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;

  void* lm_duni = own_duni ? nullptr : duni_part;
#define FRT_LM(N)                                                                                  \
  case N:                                                                                          \
    err = launch_lm<BF16, PALLAS, N>(lmp, sym, am, amax, wimg_hi, wimg_lo, rsx, rsy, z, B, S, T, C, \
                                     blank, d_lm, lm_duni, st);                                    \
    break;
  switch (pick_nb8(z.S1x)) {
    FRT_LM(4)
    FRT_LM(8)
    FRT_LM(13)
    default:
      FRT_LM(16)
  }
#undef FRT_LM
  if (err != cudaSuccess || !own_duni) return (int)err;
  if constexpr (!BF16) {
    const dim3 grid((unsigned)((C + 31) / 32), (unsigned)B);
    auto args = [&](auto kern) {
      kern<<<grid, 256, 0, st>>>(static_cast<const float*>(am), static_cast<const float*>(amax),
                                 static_cast<const float*>(rd), T, C, static_cast<float*>(duni_part));
    };
    if (prec == 0)
      args(latbuild_bwd_duni_kernel<0>);
    else
      args(latbuild_bwd_duni_kernel<1>);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch sizes, for B utterances: out[0] bytes of each part of the
// forward's lmp image (its chunks 64 bf16 or 32 TF32 columns, by the
// operand mode prec), out[1] floats of wT (per 64-frame tile and 32-row
// (64 bf16) chunk of s, a 64 x (KC + 4) tile), out[2] bytes of each part of
// the w image, out[3] bytes of each part of the lmp^T image, out[4] P.
extern "C" int frt_latbuild_sizes(int B, int S, int T, int C, int bf16, int smoothed, int prec,
                                  long long* out) {
  const Sizes z(S, T, C, bf16, smoothed);
  out[0] = (long long)B * even_chunks(C, bf16 || prec == 0 ? 64 : 32) * image_groups(S + 1) * 1024;
  out[1] = (long long)B * z.tiles * z.nKs * kPrepT * (z.KC + 4);
  out[2] = (long long)B * z.nKt * z.Gw * 1024;
  out[3] = (long long)B * z.nKs * z.Gc * 1024;
  out[4] = z.P;
  return 0;
}

// lmp (B, S1x, C) in am's dtype (float32, or bf16 with bf16 = 1) with S1x =
// S+1, or S+2 for the smoothed build (row S+1 = uni; bf16 with dnd rounds
// as the Pallas smoothed build does); symbols
// (B, S) and te (B,) int32 (te = -1: no t_end column); am (B, T, C); the
// forward's residuals amax (B, T), d (S+1, B, T) and, smoothed, duni (B, T)
// (float32); cotangents dpx (S, B, T or T+1), dpy (S+1, B, T) and,
// smoothed, dnd (S+1, B, T) (NULL for the plain build), float32.  prec, the
// operand mode of d_uni's product for float32 inputs (0 one bf16 pass, 1
// one TF32 pass, 2 3xTF32; the other products are 3xTF32 at every mode).
// Scratch, of the sizes frt_latbuild_sizes gives: wT (f32), wimg_hi and
// wimg_lo, limg_hi and (float32 only) limg_lo, colsum (B, T), rsx and rsy
// (B, P, S+1), and rd (B, T) f32, d_uni's weights -sum_s dnd / duni as the
// prep kernel forms them (float32, before any operand rounding), written
// whenever it and dnd are given; it must be given for the smoothed build on
// float32 inputs at prec 0 or 1.  Out: d_am (B, T, C) in am's dtype, d_lm
// (B, S+1, C) f32 and, smoothed, duni_part (B, C).  T >= 1.
extern "C" int frt_latbuild_bwd(const void* lmp, const void* sym, const void* te,
                                const void* am, const void* amax, const void* d,
                                const void* duni, const void* dpx, const void* dpy,
                                const void* dnd, int B, int S, int T, int C, int blank,
                                int modified, int bf16, int prec, void* wT, void* wimg_hi,
                                void* wimg_lo, void* limg_hi, void* limg_lo, void* colsum,
                                void* rsx, void* rsy, void* rd, void* d_am, void* d_lm,
                                void* duni_part, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FRT_BWD(BF, PA)                                                                               \
  return launch_bwd<BF, PA>(lmp, sym, te, am, amax, d, duni, dpx, dpy, dnd, B, S, T, C, blank, modified, \
                            prec, wT, wimg_hi, wimg_lo, limg_hi, limg_lo, colsum, rsx, rsy, rd, d_am,  \
                            d_lm, duni_part, st);
  if (bf16 && dnd != nullptr) FRT_BWD(true, true)
  if (bf16) FRT_BWD(true, false)
  FRT_BWD(false, false)
#undef FRT_BWD
}
