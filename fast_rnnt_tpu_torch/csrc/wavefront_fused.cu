// Diagonal-sweep lattice recursion kernels for Hopper (sm_90a): the forward
// recursion, the occupancy backward seeded with ans_grad, and both in one
// launch (seed 1), s-major rows, px/py stored as float, bfloat16 or float16
// (the recursion computes in float; p, the scores and the hand-off rows are
// float).  The three share one kernel template, instantiated on the phases
// it runs, so the pair run apart (seed 1) gives the fused launch's bits.
//
// Replaces the Pallas TPU kernels of fast_rnnt_tpu/ops/kernels/wavefront.py:
//   sweep_kernel<.., kFwd>   <- _fwd_kernel   (:224, pallas_call :321)
//   sweep_kernel<.., kBwd>   <- _bwd_kernel   (:420, pallas_call :517)
//   sweep_kernel<.., kBoth>  <- _fused_kernel (:623, pallas_call :765)
//
// Design: one warp per strip of an utterance sweeps anti-diagonals d = s + t.
//   forward   p[s,t] = logadd(p[s-1, t-dt] + px[s-1, t-dt], p[s,t-1] + py[s,t-1])
//   backward  g[s,t] = term2[s,t] g[s,t+1] + term1[s,t] g[s+1,t+dt]  (+ans_grad at the seed)
// with dt = 0 regular, 1 modified.  Every cell of a diagonal depends only on
// the two diagonals before it, so a diagonal is computed cell by cell with no
// scan.  A strip of kStrip = 32*kR rows is swept at a time, row i by lane
// i % 32 (slot i / 32); a row keeps its own last two cells in registers and
// gets its neighbour row's (i-1 in the forward, i+1 in the backward) by one
// warp shuffle per slot.  No recursion value ever leaves the sweeping warp
// but a strip's boundary row.  The sweep covers only the utterance's
// rectangle [s_begin, s_end] x [t_begin, t_end].  The forward's strip k reads
// its row s0-1 back from p (written by strip k-1); the backward (strips top
// down) hands the first row's g of strip k to strip k-1 through hand-off row
// k of an (nk, B, T+1) float scratch (the fused launch keeps it after p in
// its scratch, rows S+1 .. S+nk).
//
// Strips at once.  Where the padded lattice has nk > 1 strips and one
// utterance's nk blocks can all be resident, the launch has B x nk blocks,
// one a strip, and strip k trails the strip it reads by ~12 tile blocks in
// the forward (~192 steps) and ~10 in the backward: a phase takes ~T + 128 +
// (nk-1) x 192 steps, not ~nk x (T + 128).  A block takes its (utterance,
// strip) from an atomic ticket, in utterance-major order, strips ascending
// (descending for the backward alone, whose strips run top down), so it
// waits only on strips whose blocks have started: all strips of the lowest
// unfinished utterance are running, and the launch cannot hang however many
// blocks it has.  The fused launch's block sweeps its strip's forward, then
// its backward.  A strip publishes its progress on the row it hands on in a
// counter per (utterance, strip, phase): the forward the top row's tiles of
// p that the helpers have stored, the backward the steps of its first row's
// g that the sweeping warp has written, each counted up to the last block
// barrier and released by one helper thread after it.  The helper lanes that
// load the boundary tiles poll the counter below (forward) or above
// (backward) with acquire loads, backing off between them, before they read;
// the sweeping warp never polls.  The counters decide only when a block
// waits: no value passes through an atomic, so the result is the same from
// run to run, and T has no cap.  With one strip (S < 128), or more strips
// than resident blocks, the launch has B blocks, one an utterance, which
// sweep their strips one after another, with no counter and no poll.
//
// Memory.  The cells of a diagonal lie in 32 different rows, so the sweeping
// warp never touches device memory itself: each row streams through a ring
// of four 16-column tiles in shared memory.  The block's other seven warps
// load every row's next tile of px and py (the backward: p, px, py) one block
// of 16 steps ahead, coalesced, and store the finished tiles of p (px_grad,
// py_grad) back, and fill what lies outside the rectangle: the zeros of
// px_grad and py_grad (backward, fused), -inf in p (forward alone, so that
// p equals the plain version's in every cell).  They also mask the pruning
// band (lo <= s < lo + K, lo edge-padded to T+1 columns) into the px and py
// tiles as they load them, so a banded sweep runs the unbanded one's steps
// (lo read by the sweeping warp itself had doubled the banded backward's
// time, PERF.md).  The warps meet at one block barrier every 16 steps; a
// sweep that also issued its own loads and stores was bound by its ~850
// instructions a step (2.1 ms at the headline shape on an H100, PERF.md).
//
// What bounds it.  A chain of dependent steps per phase: rows + columns in
// one strip (1,100 at S=100, T=1000), ~T + 128 + (nk-1) x 192 over nk strips
// at once (~13,900 at S=1200, T=12000, against ~121,000 strip after strip),
// each kR cells of a log-add (forward) or two exps (backward) and kR
// shuffles: ~130 (forward) and ~200 (backward) instructions a step from one
// warp, whose dependent chain (a shuffle, two SFU ops, a few FP ops) leaves
// it at under half an instruction a cycle.  Latency / issue bound, one SM a
// strip, not bandwidth bound (~37 MB moved at the headline shape).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "common.cuh"

using namespace frt;

namespace {

// Storage-type codes of the C entries: 0 float, 1 bfloat16, 2 float16.
enum StorageCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

// px/py (and the occupancies written back) are stored as St = float,
// __nv_bfloat16 or __half; every value is widened to float as it is read.
// p is always float: it reaches |p| ~ 4e3 on a 1000-frame lattice, where a
// bf16 step is 16.
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

// an utterance's boundary rectangle [sb, se] x [tb, te]
struct Bnd {
  int sb, tb, se, te;
};

__device__ __forceinline__ Bnd load_bnd(const int* bnd, int b) {
  return {bnd[4 * b], bnd[4 * b + 1], bnd[4 * b + 2], bnd[4 * b + 3]};
}

constexpr int kR = 4;  // rows per lane: row i of a strip is lane i % 32, slot i / 32
constexpr int kStrip = 32 * kR;  // rows per strip
constexpr int kTile = 16;  // columns of a tile, steps of a block
constexpr int kRing = 4 * kTile;  // columns of a row's ring: four tiles
constexpr int kThreads = 256;  // the sweeping warp and kHelp helper warps
constexpr int kHelp = kThreads / 32 - 1;
constexpr int kPer = (kStrip * kTile + kHelp * 32 - 1) / (kHelp * 32);  // tile cells per helper
constexpr int kRingFloats = kStrip * kRing;
// five rings (the backward's p, px, py, px_grad, py_grad; the forward uses
// three) and two hand-off rings: 160.5 KB
constexpr int kSmem = (5 * kRingFloats + 2 * kRing) * (int)sizeof(float);
constexpr unsigned kFull = 0xffffffffu;

// 2^x and log2(x) by the SFU, denormals flushed
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;

// log(exp(x) + exp(y)), -inf for two -inf inputs, and the occupancy
// backward's safe exp, exp(x) with the x whose exp overflows float32
// (x > 88.6) or is NaN mapped to 0 (-inf - -inf contributes nothing), both
// by the SFU: as close to a float64 reference as libm's expf and log1pf
// (PERF.md)
__device__ __forceinline__ float log_add_fast(float x, float y) {
  const float m = fmaxf(x, y);
  const float r = fmaf(lg2(1.f + ex2(-fabsf(x - y) * kLog2e)), kLn2, m);
  return m == kNegInf ? kNegInf : r;
}
__device__ __forceinline__ float safe_exp_fast(float x) {
  const float e = ex2(x * kLog2e);
  return x <= 88.6f ? e : 0.f;  // false for NaN too
}

// progress counters between the blocks of one launch
__device__ __forceinline__ int ld_acquire(const int* a) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(a) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* a, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(a), "r"(v) : "memory");
}
// a helper lane's wait for a count; the back-off keeps its acquire loads
// from slowing the block's own sweep (a tight poll made the forward 15%
// slower at 10 strips on an H100, PERF.md)
__device__ __forceinline__ void wait_for(const int* a, int need) {
  while (ld_acquire(a) < need) __nanosleep(128);
}
__device__ __forceinline__ bool band_ok(int l, int s, int K) { return l <= s && s < l + K; }
__device__ __forceinline__ int ring_at(int i, int v) { return i * kRing + (v & (kRing - 1)); }
// ring_at(r * 32 + lane, c + r * 32) for each slot r: lane * kRing + r * 32 *
// kRing plus (c & 63), with bit 5 flipped on the odd slots (32 r mod 64)
__device__ __forceinline__ int ring_slot(int lane, int r, int c) {
  return (lane + r * 32) * kRing + ((c & (kRing - 1)) ^ ((r & 1) * 32));
}
// first tile of the row of rank q in the sweep order
__device__ __forceinline__ int tile0(int q) { return -((q + kTile - 1) / kTile); }

__device__ __forceinline__ int lo_at(const int* lo, int b, int T, int t) {
  return T > 0 ? __ldg(lo + b * T + min(t, T - 1)) : 0;
}

// One strip: rows s0 .. s0 + imax, columns t_begin .. t_begin + span.  Step x
// of the forward holds row i at v = x - i (t = t_begin + v); step x of the
// backward holds row i at w = x - (imax - i) (t = t_end - w).  A row's rank
// in the sweep order is i (forward) or imax - i (backward): a row of rank q
// uses tiles m + tile0(q) and m + tile0(q) + 1 in block m, so the helpers
// load tile m + tile0(q) + 2 during block m and store tile m + tile0(q) - 1.
struct Strip {
  int B, T, S, K, b, k;
  Bnd q;
  int s0, imax, span, dt, t_hi, T1, W;
  int n, nb;  // steps, blocks
  bool below_hand;  // row s0-1 exists (strip k > 0)
  bool above_hand;  // row s0+imax+1 exists (not the top strip)
  int ohg_in, ohg_out;  // backward hand-off rows, offsets into the (nk, B, T+1) hand rows
  float ag;  // backward seed at (s_end, t_end)
  // the phase's progress counters of the utterance's strips (strips at
  // once), or NULL (strip after strip)
  int* prog;
};

__device__ __forceinline__ Strip make_strip(int B, int T, int S, int K, int b, const Bnd& q,
                                            bool modified, int k, int nk, float ag = 0.f,
                                            int* prog = nullptr) {
  Strip g;
  g.B = B, g.T = T, g.S = S, g.K = K, g.b = b, g.k = k, g.q = q;
  g.s0 = q.sb + k * kStrip;
  g.imax = min(kStrip - 1, q.se - g.s0);
  g.span = q.te - q.tb;
  g.dt = modified ? 1 : 0;
  g.t_hi = q.te - g.dt;
  g.T1 = modified ? T : T + 1;
  g.W = T + 1;
  g.n = g.imax + g.span + 1;
  g.nb = (g.n + kTile - 1) / kTile;
  g.below_hand = k > 0;
  g.above_hand = k < nk - 1;
  g.ohg_in = ((k + 1) * B + b) * g.W;
  g.ohg_out = (k * B + b) * g.W;
  g.ag = ag;
  g.prog = prog;
  return g;
}

// strips at once: publish a count to the strip that waits on this one; the
// writes before the block barrier that the publishing thread has passed are
// visible to the block that acquires the count
__device__ __forceinline__ void publish(const Strip& g, int done) {
  if (done > 0) st_release(g.prog + g.k, done);
}

template <class St>
__device__ __forceinline__ float ld_masked(const St* a, bool ok) {
  return ok ? to_f(__ldg(a)) : kNegInf;
}

// --- helper warps (h: thread index among them) ------------------------------

// forward: tile m + tile0(i) + 1 of px and py of every row into the rings,
// -inf outside the rectangle and the band, and row s0-1's p for row 0
template <class St, bool kBand, bool kAt>
__device__ void fwd_load(const Strip& g, const St* px, const St* py, const int* lo, const float* p,
                         float* sm, int h, int m) {
  float* rpx = sm;
  float* rpy = sm + kRingFloats;
  float* hand = sm + 5 * kRingFloats;
  float x[kPer], y[kPer];
  int at[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = h + k * kHelp * 32, i = e / kTile;
    const int v = (m + tile0(i) + 1) * kTile + e % kTile;
    const int s = g.s0 + i, t = g.q.tb + v, tp = t - g.dt;
    const bool row = i <= g.imax;
    at[k] = row ? ring_at(i, v) : -1;
    // px[s-1, tp] enters (s, t) in band lo[tp], py[s, t-1] in band lo[t-1]
    const bool okx = row && s > g.q.sb && tp >= g.q.tb && tp <= g.t_hi;
    const bool oky = row && t - 1 >= g.q.tb && t - 1 < g.q.te;
    x[k] = ld_masked(px + ((s - 1) * g.B + g.b) * g.T1 + tp,
                     okx && (!kBand || band_ok(lo_at(lo, g.b, g.T, tp), s - 1, g.K)));
    y[k] = ld_masked(py + (s * g.B + g.b) * g.T + t - 1,
                     oky && (!kBand || band_ok(lo_at(lo, g.b, g.T, t - 1), s, g.K)));
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (at[k] >= 0) {
      rpx[at[k]] = x[k];
      rpy[at[k]] = y[k];
    }
  if (h < kTile) {
    const int v = (m + 1) * kTile + h, tp = g.q.tb + v - g.dt;
    float hv = kNegInf;
    if (g.below_hand && tp >= g.q.tb && tp <= g.t_hi) {
      // strip k-1 has stored the tile of its top row that holds column tp
      if constexpr (kAt) wait_for(g.prog + g.k - 1, (tp - g.q.tb) / kTile + 1);
      hv = __ldcg(p + ((g.s0 - 1) * g.B + g.b) * g.W + tp);
    }
    hand[v & (kRing - 1)] = hv;
  }
}

// forward: tile m + tile0(i) - 1 of p of every row to the scratch
__device__ void fwd_store(const Strip& g, float* p, const float* sm, int h, int m) {
  const float* rp = sm + 2 * kRingFloats;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = h + k * kHelp * 32, i = e / kTile;
    const int v = (m + tile0(i) - 1) * kTile + e % kTile;
    if (i <= g.imax && v >= 0 && v <= g.span)
      p[((g.s0 + i) * g.B + g.b) * g.W + g.q.tb + v] = rp[ring_at(i, v)];
  }
}

// backward: tile m + tile0(imax - i) + 1 of p, px and py of every row (px
// and py -inf outside the rectangle and the band), and row s0+imax+1's p and
// its g (from the hand-off rows) for the top row
template <class St, bool kBand, bool kAt>
__device__ void bwd_load(const Strip& g, const St* px, const St* py, const int* lo, const float* p,
                         const float* hrows, float* sm, int h, int m) {
  float* rpp = sm;
  float* rpx = sm + kRingFloats;
  float* rpy = sm + 2 * kRingFloats;
  float* hand = sm + 5 * kRingFloats;
  float pv[kPer], x[kPer], y[kPer];
  int at[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = h + k * kHelp * 32, qk = e / kTile, i = g.imax - qk;
    const int w = (m + tile0(qk) + 1) * kTile + e % kTile;
    const int s = g.s0 + i, t = g.q.te - w;
    const bool in = i >= 0 && t >= g.q.tb && t <= g.q.te;
    const bool band = in && (!kBand || band_ok(lo_at(lo, g.b, g.T, t), s, g.K));
    at[k] = i >= 0 ? ring_at(i, w) : -1;
    pv[k] = in ? __ldcg(p + (s * g.B + g.b) * g.W + t) : kNegInf;
    x[k] = ld_masked(px + (s * g.B + g.b) * g.T1 + t, band && s < g.q.se && t <= g.t_hi);
    y[k] = ld_masked(py + (s * g.B + g.b) * g.T + t, band && t < g.q.te);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    if (at[k] >= 0) {
      rpp[at[k]] = pv[k];
      rpx[at[k]] = x[k];
      rpy[at[k]] = y[k];
    }
  if (h < kTile) {
    const int w = (m + 1) * kTile + h, tn = g.q.te - w + g.dt;  // the top row's w is the step
    float hp = kNegInf, hg = 0.f;
    if (g.above_hand && tn >= g.q.tb && tn <= g.q.te) {
      // the strip above has written its first row's g at w - dt
      if constexpr (kAt) wait_for(g.prog + g.k + 1, w - g.dt + 1);
      hp = __ldcg(p + ((g.s0 + g.imax + 1) * g.B + g.b) * g.W + tn);
      hg = __ldcg(hrows + g.ohg_in + tn);
    }
    hand[w & (kRing - 1)] = hp;
    hand[kRing + (w & (kRing - 1))] = hg;
  }
}

// backward: tile m + tile0(imax - i) - 1 of px_grad and py_grad to the outputs
template <class St>
__device__ void bwd_store(const Strip& g, St* pxg, St* pyg, const float* sm, int h, int m) {
  const float* rgx = sm + 3 * kRingFloats;
  const float* rgy = sm + 4 * kRingFloats;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int e = h + k * kHelp * 32, qk = e / kTile, i = g.imax - qk;
    const int w = (m + tile0(qk) - 1) * kTile + e % kTile;
    if (i >= 0 && w >= 0 && w <= g.span) {
      const int s = g.s0 + i, t = g.q.te - w;
      if (t < g.T) pyg[(s * g.B + g.b) * g.T + t] = from_f<St>(rgy[ring_at(i, w)]);
      if (s < g.S && t < g.T1) pxg[(s * g.B + g.b) * g.T1 + t] = from_f<St>(rgx[ring_at(i, w)]);
    }
  }
}

// zeros of px_grad (unit odd) or py_grad (even) in row unit / 2 outside the
// rectangle, by one helper warp
template <class St>
__device__ void zero_row(const Strip& g, St* pxg, St* pyg, int unit, int lane) {
  const int s = unit >> 1, out = unit & 1;
  if (out == 1 && s == g.S) return;
  const int n = out ? g.T1 : g.T;
  St* o = (out ? pxg : pyg) + (s * g.B + g.b) * n;
  const bool in_s = s >= g.q.sb && s <= g.q.se;
  const int a = in_s ? min(g.q.tb, n) : n, c = in_s ? g.q.te + 1 : n;  // [0, a) and [c, n)
  const St z = from_f<St>(0.f);
  for (int t = lane; t < a; t += 32) o[t] = z;
  for (int t = c + lane; t < n; t += 32) o[t] = z;
}

// -inf of p in row s outside the rectangle, by one helper warp (the forward
// alone: the fused launch's p is scratch)
__device__ void neg_row(const Strip& g, float* p, int s, int lane) {
  float* o = p + (s * g.B + g.b) * g.W;
  const bool in_s = s >= g.q.sb && s <= g.q.se;
  const int a = in_s ? g.q.tb : g.W, c = in_s ? g.q.te + 1 : g.W;  // [0, a) and [c, W)
  for (int t = lane; t < a; t += 32) o[t] = kNegInf;
  for (int t = c + lane; t < g.W; t += 32) o[t] = kNegInf;
}

// --- the sweeping warp ----------------------------------------------------

// Per-slot constants of the sweeping warp's rows in one strip.
struct Rows {
  int i[kR];  // row in the strip
  int s[kR];  // lattice row
  bool row[kR];  // i <= imax
  bool first[kR];  // s == s_begin (the origin row)
  bool last[kR];  // s == s_end (the score / seed row)

  __device__ __forceinline__ void init(const Strip& g, int lane) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      i[r] = r * 32 + lane;
      s[r] = g.s0 + i[r];
      row[r] = i[r] <= g.imax;
      first[r] = s[r] == g.q.sb;
      last[r] = s[r] == g.q.se;
    }
  }
};

// A step of the sweep reads all its ring cells first (the next step's before
// this one's stores), then shuffles, computes and stores: the kR cells of a
// step are independent, and reading after a store into the same shared
// array would serialize them.
template <bool kMod>
struct FwdSweep {
  Rows rw;
  float v1[kR], v2[kR];  // p of the row on the last two steps
  float xa[kR], ya[kR], hv;  // ring cells of the coming step

  __device__ __forceinline__ void read(const float* sm, int lane, int x) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int at = ring_slot(lane, r, x - lane);  // row i at v = x - i
      xa[r] = sm[at];
      ya[r] = sm[kRingFloats + at];
    }
    hv = sm[5 * kRingFloats + (x & (kRing - 1))];
  }

  __device__ __forceinline__ void init(const Strip& g, int lane) {
    rw.init(g, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      v1[r] = v2[r] = kNegInf;
    }
  }

  __device__ __forceinline__ void step(const Strip& g, float* sm, int lane, int x) {
    float nv[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float src = lane == 31 ? (r > 0 ? (kMod ? v2[r - 1] : v1[r - 1]) : 0.f)
                                   : (kMod ? v2[r] : v1[r]);
      nv[r] = __shfl_sync(kFull, src, (lane + 31) & 31);  // row i-1
    }
    if (lane == 0) nv[0] = hv;  // row s0-1
    bool act[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int v = x - rw.i[r];
      act[r] = rw.row[r] && (unsigned)v <= (unsigned)g.span;
      float a = nv[r] + xa[r];
      if (r == 0 && x == 0 && rw.first[0]) a = 0.f;  // origin p[s_begin, t_begin] = 0 (row 0, step 0)
      const float val = log_add_fast(a, v1[r] + ya[r]);
      nv[r] = act[r] ? val : kNegInf;
    }
    read(sm, lane, x + 1);
    // every slot stores, active or not: the slot a cell maps to does not
    // depend on it, and the helpers store only cells inside the rectangle
    float* rp = sm + 2 * kRingFloats;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      rp[ring_slot(lane, r, x - lane)] = nv[r];
      v2[r] = v1[r];
      v1[r] = nv[r];
    }
  }

  // after the top strip's last step, p[s_end, t_end] is its row's last cell
  __device__ __forceinline__ void score(const Strip& g, float* scores) const {
#pragma unroll
    for (int r = 0; r < kR; ++r)
      if (rw.last[r]) scores[g.b] = v1[r];
  }
};

template <bool kMod>
struct BwdSweep {
  Rows rw;
  float pc1[kR];  // p[s, t+1]
  float g1[kR], g2[kR];  // g[s, t+1], g[s, t+2]
  float pa[kR], pn[kR], xa[kR], ya[kR], hp, hg;  // ring cells of the coming step

  __device__ __forceinline__ void read(const Strip& g, const float* sm, int lane, int x) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int at = ring_slot(lane, r, x - g.imax + lane);  // row i at w = x - imax + i
      pa[r] = sm[at];
      // p[s+1, t+dt], row i+1's cell dt steps back, still in its ring (the
      // top slot of lane 31 reads past the ring; the hand-off ring serves it)
      pn[r] = sm[ring_slot(lane, r, x - g.imax + lane - g.dt) + kRing];
      xa[r] = sm[kRingFloats + at];
      ya[r] = sm[2 * kRingFloats + at];
    }
    hp = sm[5 * kRingFloats + (x & (kRing - 1))];
    hg = sm[5 * kRingFloats + kRing + (x & (kRing - 1))];
  }

  __device__ __forceinline__ void init(const Strip& g, int lane) {
    rw.init(g, lane);
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      pc1[r] = kNegInf;
      g1[r] = g2[r] = 0.f;
    }
  }

  __device__ __forceinline__ void step(const Strip& g, float* sm, float* hrows, int lane, int x) {
    float ap[kR], ag[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      // g of row i+1 at t+dt: lane+1 of this slot, or lane 0 of the next slot
      const float sg = lane == 0 ? (r < kR - 1 ? (kMod ? g2[r + 1] : g1[r + 1]) : 0.f)
                                 : (kMod ? g2[r] : g1[r]);
      ag[r] = __shfl_sync(kFull, sg, (lane + 1) & 31);
      ap[r] = pn[r];
    }
    if (lane == 31) {  // row s0+kStrip, the strip above
      ap[kR - 1] = hp;
      ag[kR - 1] = hg;
    }
    bool act[kR];
    float npc[kR], ng[kR], gy[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int w = x - g.imax + rw.i[r];
      act[r] = rw.row[r] && (unsigned)w <= (unsigned)g.span;
      const float h = safe_exp_fast(pa[r] + xa[r] - ap[r]) * ag[r];
      const float c = safe_exp_fast(pa[r] + ya[r] - pc1[r]);
      const float seed = (rw.last[r] && x == 0) ? g.ag : 0.f;  // (s_end, t_end): row imax, step 0
      ng[r] = act[r] ? fmaf(c, g1[r], h + seed) : 0.f;
      npc[r] = act[r] ? pa[r] : kNegInf;
      gy[r] = c * g1[r];
      ap[r] = h;  // px_grad
    }
    read(g, sm, lane, x + 1);
    // row 0's g to the hand-off row for the strip below: every lane stores
    // lane 0's value, under a condition the whole warp shares
    const float g0 = __shfl_sync(kFull, ng[0], 0);
    const int w0 = x - g.imax;
    if (g.below_hand && (unsigned)w0 <= (unsigned)g.span) hrows[g.ohg_out + g.q.te - w0] = g0;
    float* rgx = sm + 3 * kRingFloats;
    float* rgy = sm + 4 * kRingFloats;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int at = ring_slot(lane, r, x - g.imax + lane);
      rgy[at] = gy[r];
      rgx[at] = ap[r];
      pc1[r] = npc[r];
      g2[r] = g1[r];
      g1[r] = ng[r];
    }
  }
};

// The phases a launch runs: the forward alone, the backward alone, or both
enum Phases { kFwd = 1, kBwd = 2, kBoth = 3 };

// p: (S+1, B, T+1), written by the forward (kFwd: every cell, -inf outside
// the rectangle; kBoth: the rectangle) and read by the backward; hrows: the
// backward's (nk, B, T+1) hand-off rows; ans_grad: the backward's seeds, or
// NULL for seed 1.  ctr: NULL, one block an utterance sweeping its strips
// one after another; or the ticket and the forward's and backward's progress
// counters of each (utterance, strip), (1 + 2 B nk) ints, zero at the launch,
// for B x nk blocks, one a strip.
template <class St, bool kMod, bool kBand, int kPh, bool kAt>
__global__ void __launch_bounds__(kThreads)
sweep_kernel(const St* __restrict__ px, const St* __restrict__ py, const int* __restrict__ bnd,
             const int* __restrict__ lo, int K, int S, int B, int T,
             const float* __restrict__ ans_grad, float* p, float* hrows,
             float* __restrict__ scores, St* __restrict__ pxg, St* __restrict__ pyg, int nk_grid,
             int* ctr) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = threadIdx.x - 32;  // thread index among the helper warps
  int b = blockIdx.x, kk = 0;  // utterance; strip (strips at once)
  if constexpr (kAt) {
    __shared__ int ticket;
    if (threadIdx.x == 0) ticket = atomicAdd(ctr, 1);
    __syncthreads();
    b = ticket / nk_grid;
    kk = ticket % nk_grid;
    if (kPh == kBwd) kk = nk_grid - 1 - kk;
  }
  const Bnd q = load_bnd(bnd, b);
  const int nr = q.se - q.sb + 1;
  const int nk = nr > 0 && q.te >= q.tb ? (nr + kStrip - 1) / kStrip : 0;
  // the strips this block sweeps: all of the utterance's, or strip kk alone
  const int k_lo = kAt ? kk : 0, k_hi = kAt ? min(kk, nk - 1) : nk - 1;
  int* fprog = kAt ? ctr + 1 + b * nk_grid : nullptr;
  int* bprog = kAt ? ctr + 1 + (B + b) * nk_grid : nullptr;
  // strips at once: the thread that publishes this block's progress, after
  // each block barrier
  const bool poster = kAt && warp == kHelp && lane == 0;
  // a runtime value in every instantiation, so that seed 1 takes the same
  // operations fused and apart
  const float ag = ans_grad != nullptr ? __ldg(ans_grad + b) : 1.f;
  // fill units outside the rectangle, one per helper warp and block of the
  // first phase, the rest after it, shared among the utterance's blocks: -inf
  // of p (one per row, kFwd) or the zeros of (row, output) (two per row, kBwd
  // and kBoth)
  const int nunits = kPh == kFwd ? S + 1 : 2 * (S + 1);
  int unit = warp - 1 + kk * kHelp;
  auto fill = [&](const Strip& g) {
    if (unit < nunits) {
      if (kPh == kFwd)
        neg_row(g, p, unit, lane);
      else
        zero_row(g, pxg, pyg, unit, lane);
    }
    unit += kAt ? kHelp * nk_grid : kHelp;
  };
  auto fill_rest = [&]() {
    const Strip g = make_strip(B, T, S, K, b, q, kMod, 0, 1);
    while (unit < nunits) fill(g);
  };

  if (kPh & kFwd) {
    if (nk == 0 && kk == 0 && threadIdx.x == 0) scores[b] = kNegInf;
    for (int k = k_lo; k <= k_hi; ++k) {
      const Strip g = make_strip(B, T, S, K, b, q, kMod, k, nk, 0.f, fprog);
      FwdSweep<kMod> f;
      if (warp == 0) {
        f.init(g, lane);
      } else {
        fwd_load<St, kBand, kAt>(g, px, py, lo, p, sm, h, -1);
        fwd_load<St, kBand, kAt>(g, px, py, lo, p, sm, h, 0);
      }
      __syncthreads();
      if (warp == 0) f.read(sm, lane, 0);  // the prologue's tiles are in
      for (int m = 0; m < g.nb; ++m) {
        if (warp == 0) {
          for (int x = m * kTile; x < min(g.n, (m + 1) * kTile); ++x)
            f.step(g, sm, lane, x);
          if (m == g.nb - 1 && k == nk - 1) f.score(g, scores);
        } else {
          // the top row's tiles 0 .. m + tile0(imax) - 2, stored by fwd_store(m-1)
          if (poster && g.above_hand) publish(g, m - 1 + tile0(g.imax));
          if (m + 1 < g.nb) fwd_load<St, kBand, kAt>(g, px, py, lo, p, sm, h, m + 1);
          fwd_store(g, p, sm, h, m);
          fill(g);
        }
        __syncthreads();  // tiles of block m+1 in, block m's cells written
      }
      if (warp > 0) {
        fwd_store(g, p, sm, h, g.nb);
        fwd_store(g, p, sm, h, g.nb + 1);
      }
      __syncthreads();  // the strip's p is stored before the next strip (or the backward) reads it
      if (poster && g.above_hand) publish(g, g.nb + 1 + tile0(g.imax));  // every tile
    }
    if (warp > 0) fill_rest();
  }
  if (kPh & kBwd) {
    for (int k = k_hi; k >= k_lo; --k) {
      const Strip g = make_strip(B, T, S, K, b, q, kMod, k, nk, ag, bprog);
      BwdSweep<kMod> f;
      if (warp == 0) {
        f.init(g, lane);
      } else {
        bwd_load<St, kBand, kAt>(g, px, py, lo, p, hrows, sm, h, -1);
        bwd_load<St, kBand, kAt>(g, px, py, lo, p, hrows, sm, h, 0);
      }
      __syncthreads();
      if (warp == 0) f.read(g, sm, lane, 0);  // the prologue's tiles are in
      for (int m = 0; m < g.nb; ++m) {
        if (warp == 0) {
          for (int x = m * kTile; x < min(g.n, (m + 1) * kTile); ++x)
            f.step(g, sm, hrows, lane, x);
        } else {
          // the first row's g of steps 0 .. 16m-1
          if (poster && g.below_hand) publish(g, m * kTile - g.imax);
          if (m + 1 < g.nb) bwd_load<St, kBand, kAt>(g, px, py, lo, p, hrows, sm, h, m + 1);
          bwd_store(g, pxg, pyg, sm, h, m);
          if (kPh == kBwd) fill(g);
        }
        __syncthreads();
      }
      if (warp > 0) {
        if (poster && g.below_hand) publish(g, g.span + 1);  // every step
        bwd_store(g, pxg, pyg, sm, h, g.nb);
        bwd_store(g, pxg, pyg, sm, h, g.nb + 1);
      }
      __syncthreads();  // the hand-off row is stored before the strip below reads it
    }
    if (kPh == kBwd && warp > 0) fill_rest();
  }
}

struct Args {
  const void *px, *py, *bnd, *lo;
  int K, S, B, T;
  const void* ans_grad;
  void *p, *hrows, *scores, *pxg, *pyg;
  int nk;  // strips at once: B x nk blocks and the counters ctr; 1: B blocks
  void* ctr;
};

template <class St, int kPh, bool kMod, bool kBand>
int launch(const Args& a, cudaStream_t stream) {
  const bool at_once = a.nk > 1 && a.ctr != nullptr;
  auto kern = at_once ? sweep_kernel<St, kMod, kBand, kPh, true>
                      : sweep_kernel<St, kMod, kBand, kPh, false>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  const int nk = at_once ? a.nk : 1;
  if (at_once) {
    const cudaError_t e =
        cudaMemsetAsync(a.ctr, 0, sizeof(int) * (1 + 2 * (size_t)a.B * nk), stream);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<a.B * nk, kThreads, kSmem, stream>>>(
      static_cast<const St*>(a.px), static_cast<const St*>(a.py), static_cast<const int*>(a.bnd),
      static_cast<const int*>(a.lo), a.K, a.S, a.B, a.T, static_cast<const float*>(a.ans_grad),
      static_cast<float*>(a.p), static_cast<float*>(a.hrows), static_cast<float*>(a.scores),
      static_cast<St*>(a.pxg), static_cast<St*>(a.pyg), nk,
      at_once ? static_cast<int*>(a.ctr) : nullptr);
  return (int)cudaGetLastError();
}

template <class St, int kPh>
int launch_masks(const Args& a, int modified, cudaStream_t st) {
  if (modified)
    return a.lo ? launch<St, kPh, true, true>(a, st) : launch<St, kPh, true, false>(a, st);
  return a.lo ? launch<St, kPh, false, true>(a, st) : launch<St, kPh, false, false>(a, st);
}

template <int kPh>
int launch_sweep(const Args& a, int modified, int threads, int dtype, void* stream) {
  if (threads != kThreads) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return launch_masks<float, kPh>(a, modified, st);
    case kBF16:
      return launch_masks<__nv_bfloat16, kPh>(a, modified, st);
    case kF16:
      return launch_masks<__half, kPh>(a, modified, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" const char* frt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Every entry: px (S, B, T') and py (S+1, B, T) in the storage type named by
// `dtype` (StorageCode); lo may be NULL (no band); `threads` must be 256 (one
// sweeping warp, seven helpers).  nk > 1 with ctr, (1 + 2 B nk) int32
// scratch that the entry zeroes on the stream: B x nk blocks, one a strip,
// nk = ceil((S+1) / 128), which the caller gives only where nk blocks fit on
// the device at once (frt_sweep_resident); otherwise (nk 1, ctr NULL) one
// block an utterance.  hrows: (ceil((S+1) / 128), B, T+1) f32 scratch.

// The blocks of the sweep kernels that the device holds at once (its SMs
// times the blocks of 160.5 KB of shared memory one SM holds), or minus a
// CUDA error code.
extern "C" int frt_sweep_resident(int device) {
  int sms = 0, per_sm = 0;
  cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return -(int)e;
  // every instantiation has the same block and shared memory
  auto kern = sweep_kernel<float, false, false, kBoth, true>;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, kSmem);
  return e == cudaSuccess ? sms * per_sm : -(int)e;
}

// p: (S+1, B, T+1) f32 out, -inf outside each rectangle; scores: (B,) f32 out.
extern "C" int frt_sweep_fwd(const void* px, const void* py, const void* bnd, const void* lo, int K,
                             int S, int B, int T, int modified, void* p, void* scores, int threads,
                             int dtype, int nk, void* ctr, void* stream) {
  const Args a{px, py, bnd, lo, K, S, B, T, nullptr, p, nullptr, scores, nullptr, nullptr, nk, ctr};
  return launch_sweep<kFwd>(a, modified, threads, dtype, stream);
}

// p: (S+1, B, T+1) f32 in; ans_grad: (B,) f32 seeds; hrows: the hand-off
// rows; pxg (S, B, T') and pyg (S+1, B, T) out in the storage type.
extern "C" int frt_sweep_bwd(const void* px, const void* py, const void* p, const void* bnd,
                             const void* lo, int K, const void* ans_grad, int S, int B, int T,
                             int modified, void* hrows, void* pxg, void* pyg, int threads,
                             int dtype, int nk, void* ctr, void* stream) {
  const Args a{px, py, bnd, lo, K, S, B, T, ans_grad, const_cast<void*>(p), hrows, nullptr, pxg,
               pyg, nk, ctr};
  return launch_sweep<kBwd>(a, modified, threads, dtype, stream);
}

// p: (S+1+ceil((S+1)/128), B, T+1) f32 scratch (rows 0..S the forward
// lattice, then the backward's hand-off rows); scores: (B,) f32 out; pxg,
// pyg out; seed 1.
extern "C" int frt_wavefront_fused(const void* px, const void* py, const void* bnd,
                                   const void* lo, int K, int S, int B, int T, int modified,
                                   void* p, void* scores, void* pxg, void* pyg, int threads,
                                   int dtype, int nk, void* ctr, void* stream) {
  float* hrows = static_cast<float*>(p) + (size_t)(S + 1) * B * (T + 1);
  const Args a{px, py, bnd, lo, K, S, B, T, nullptr, p, hrows, scores, pxg, pyg, nk, ctr};
  return launch_sweep<kBoth>(a, modified, threads, dtype, stream);
}
