// Hopper (sm_90a) building blocks of the lattice-build kernels: mbarriers,
// bulk asynchronous copies (cp.async.bulk) and 2D tensor-map loads (TMA),
// wgmma on operands in TF32 or bf16, the TF32 / bf16 operand splits, and
// the "image" layout of a shared-memory B operand.
//
// B operand images.  wgmma reads B from shared memory K-major (TF32 only
// has that form) through a descriptor.  The kernels use the layout without
// swizzle: a core matrix is 8 rows of 16 bytes (4 TF32 or 8 bf16 values
// along K), stored as 128 contiguous bytes.  An image holds a matrix of R
// rows and K columns cut into chunks of KC columns; inside a chunk, the
// core matrices of one 8-row group lie side by side along K (leading byte
// offset 128) and the groups follow one another (stride byte offset
// KC / epc * 128).  One chunk of all groups is contiguous, so one bulk copy
// stages it, and a block that owns a range of 8-row groups copies one
// contiguous piece.  `image_kernel` writes such images from an ordinary
// strided matrix, splitting float32 values into TF32 hi / lo parts.
//
// 3xTF32.  A float32 x is split as hi = tf32(x), lo = tf32(x - hi) (round
// to nearest); x - hi - lo is within 2^-22 |x|.  A product x y is taken as
// lo_x hi_y + hi_x lo_y + hi_x hi_y, three TF32 wgmmas accumulating in
// float32 (the lo lo term, ~2^-22 |x y|, is dropped): ~2^-21 relative per
// product, as CUTLASS's "fast accurate" 3xTF32 GEMMs.
//
// Operand modes of float32 inputs (the matmul precision levels): 2, 3xTF32
// as above; 1, the hi parts alone, one TF32 pass (both operands rounded by
// cvt.rna: to nearest, ties away from zero); 0, one bf16 pass (both rounded
// to nearest even).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace frt {

#define FRT_DEV __device__ __forceinline__

// ---- shared-memory addresses, mbarriers, bulk copies ----------------------

FRT_DEV uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

FRT_DEV void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

FRT_DEV void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of copies completing on `bar`
FRT_DEV void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait for the completion of the barrier's phase of parity `parity`
FRT_DEV void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(a),
      "r"(parity)
      : "memory");
}

// global -> shared copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned), completing on `bar`
FRT_DEV void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// 4-byte asynchronous copy global -> shared (Ampere's cp.async); with
// `valid` false it writes zeros and reads nothing
FRT_DEV void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// an arrival on `bar` once this thread's earlier cp.async copies are done
// (counted among the barrier's expected arrivals)
FRT_DEV void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
FRT_DEV void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
FRT_DEV void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

FRT_DEV void prefetch_l2(const void* p) { asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p)); }

// ---- operand values --------------------------------------------------------

FRT_DEV uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo (+ 2^-22 |x|), both TF32
FRT_DEV void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

FRT_DEV float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

FRT_DEV float tf32r(float x) { return __uint_as_float(to_tf32(x)); }

// x as an operand of a product in operand mode OP: bf16 (0), TF32 (1) or
// float32 (2: a scalar product's own precision)
template <int OP>
FRT_DEV float op_round(float x) {
  if constexpr (OP == 0) return bf16r(x);
  if constexpr (OP == 1) return tf32r(x);
  return x;
}

FRT_DEV uint32_t bf16_bits(float x) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(x)));
}

// two bf16 values in one register, the lower column in the low half
FRT_DEV uint32_t pack_bf16(float lo_col, float hi_col) {
  return bf16_bits(lo_col) | (bf16_bits(hi_col) << 16);
}

// x = hi + lo (+ 2^-16 |x|), both bf16, packed for two columns
FRT_DEV void split_bf16x2(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const float h0 = bf16r(x0), h1 = bf16r(x1);
  hi = pack_bf16(h0, h1);
  lo = pack_bf16(x0 - h0, x1 - h1);
}

// exp(a - m), the products' exp side: float32 inputs through the SFU
// (__expf, ~1e-6 relative at the build's arguments, the order of a 3xTF32
// product's own error); bf16 inputs rounded as bf16 arithmetic rounds them
// (the shift, then the exp), to match the plain bf16 build bit for bit, or,
// PALLAS (the smoothed build), as the Pallas build rounds them: the exp of
// the float32 shift, rounded once
template <bool BF16, bool PALLAS = false>
FRT_DEV float shifted_exp(float a, float m) {
  if constexpr (BF16 && PALLAS) return bf16r(expf(a - m));
  return BF16 ? bf16r(expf(bf16r(a - m))) : __expf(a - m);
}

// exp(a - m) as the products take it in operand mode OP (float32 inputs):
// shifted_exp's __expf in mode 2, whose error is below 3xTF32's; where the
// value is rounded to TF32 or bf16 (modes 1 and 0), CUDA's expf, the exp
// torch.exp computes, so that the rounding meets the value the plain
// emulation rounds (an exp one ulp apart can round to the next step)
template <bool BF16, bool PALLAS, int OP>
FRT_DEV float operand_exp(float a, float m) {
  if constexpr (BF16 || OP == 2) return shifted_exp<BF16, PALLAS>(a, m);
  return expf(a - m);
}

template <typename T>
FRT_DEV float ld_f(const T* p) {
  if constexpr (sizeof(T) == 2)
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  else
    return *p;
}

// ---- wgmma ------------------------------------------------------------------

// descriptor of a no-swizzle K-major operand at shared address `addr`:
// core matrices `lbo` bytes apart along K, 8-row groups `sbo` bytes apart
FRT_DEV uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

FRT_DEV void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
FRT_DEV void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }

// keeps the compiler from moving reads or writes of an accumulator across
// the asynchronous products
FRT_DEV void fence_reg(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// D(64 x N) += A(64 x K, registers) B(K x N, shared, K-major) for one
// k-step (K = 8 TF32 or 16 bf16), one wgmma of the block's whole width
// (N = 8 NB8: narrow products run the tensor cores well below their
// rate).  A fragment: each warp owns 16 rows; lane (g = lane / 4, q = lane
// % 4) holds rows g and g + 8 at columns q and q + 4 (TF32) or column pairs
// 2q, 2q + 1 and 2q + 8, 2q + 9 (bf16), in the order (g, lo cols), (g + 8,
// lo cols), (g, hi cols), (g + 8, hi cols).
template <bool BF16, int N>
struct Mma;

template <>
struct Mma<false, 32> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<true, 32> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<false, 64> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<true, 64> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<false, 104> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
        "{%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<true, 104> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51}, "
        "{%52, %53, %54, %55}, %56, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<false, 128> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <>
struct Mma<true, 128> {
  static FRT_DEV void run(float* d, const uint32_t (&a)[4], uint64_t desc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
  }
};

template <int N>
FRT_DEV void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The N tile (in 8-row groups) for a B operand of `rows` rows: the
// smallest of 4, 8, 13 (104 rows: S = 100's 101), 16 that holds them, else
// tiles of 16.  Block products are 64 x (8 NB8), one template instance per
// width, straight-line code for each (no branch between products, which
// would make ptxas serialize them).
inline __host__ __device__ int pick_nb8(int rows) {
  const int g = (rows + 7) / 8;
  return g <= 4 ? 4 : g <= 8 ? 8 : g <= 13 ? 13 : 16;
}

// 8-row groups of a B operand image of `rows` rows, padded to whole N tiles
inline __host__ __device__ int image_groups(int rows) {
  const int nb8 = pick_nb8(rows), g = (rows + 7) / 8;
  return (g + nb8 - 1) / nb8 * nb8;
}

// D(64 x 8 NB8) += A B for one k-step; `desc` addresses row 0 of B.  The
// accumulator holds 4 NB8 floats a thread: element 4j + e is row g + 8
// (e / 2), column 8j + 2q + (e % 2) of the warp's 16 rows.
template <bool BF16, int NB8>
FRT_DEV void mma_rows(float (&acc)[4 * NB8], const uint32_t (&a)[4], uint64_t desc) {
  Mma<BF16, 8 * NB8>::run(acc, a, desc);
}

// Issue one chunk of 4 k-steps (KC = 4 k-steps of K) and commit it as one
// group: D += A B, B the chunk of an image at shared address `bhi` (its lo
// part `blo_off` bytes further), A's fragments in (ah, al).  Products:
// lo_A hi_B (ALO), hi_A lo_B (BLO), hi_A hi_B, smallest first.
template <bool BF16, bool ALO, bool BLO, int NB8>
FRT_DEV void issue_chunk(float (&acc)[4 * NB8], const uint32_t (&ah)[4][4],
                         const uint32_t (&al)[4][4], uint32_t bhi, uint32_t blo_off) {
  wg_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const uint64_t dh = make_desc(bhi + ks * 256, 128, 1024);
    if constexpr (ALO) mma_rows<BF16, NB8>(acc, al[ks], dh);
    if constexpr (BLO) mma_rows<BF16, NB8>(acc, ah[ks], dh + (uint64_t)(blo_off >> 4));
    mma_rows<BF16, NB8>(acc, ah[ks], dh);
  }
  wg_commit();
}

// The K loop of a block product over nK chunks (nK even, >= 2: callers pad
// with zero chunks), software-pipelined: chunk k + 1's A fragments are
// formed (`frag(k, ah, al)`, after `wait_full(k)`) while chunk k's
// products run, then chunk k is waited for and `release(k)` frees its
// shared-memory stage.  `bbase(k)` is the shared address of chunk k's B
// (hi part).  Two fragment buffers, used in turns; no product is issued
// under a branch (ptxas would serialize them).
template <bool BF16, bool ALO, bool BLO, int NB8, class Wait, class Frag, class Base, class Release>
FRT_DEV void mainloop(float (&acc)[4 * NB8], int nK, uint32_t blo_off, Wait wait_full, Frag frag,
                      Base bbase, Release release) {
  uint32_t ah0[4][4], al0[4][4], ah1[4][4], al1[4][4];
  auto step = [&](int k, uint32_t(&ah)[4][4], uint32_t(&al)[4][4]) {
    wait_full(k);
    frag(k, ah, al);
    issue_chunk<BF16, ALO, BLO, NB8>(acc, ah, al, bbase(k), blo_off);
  };
  step(0, ah0, al0);
  for (int k = 0; k + 2 < nK; k += 2) {
    step(k + 1, ah1, al1);
    wg_wait<1>();
    release(k);
    step(k + 2, ah0, al0);
    wg_wait<1>();
    release(k + 1);
  }
  step(nK - 1, ah1, al1);
  wg_wait<1>();
  release(nK - 2);
  wg_wait<0>();
  release(nK - 1);
#pragma unroll
  for (int i = 0; i < 4 * NB8; ++i) fence_reg(acc[i]);
}

// chunks of K, padded to an even count (the pipelined loop's unit)
inline __host__ __device__ int even_chunks(int K, int KC) {
  const int n = (K + KC - 1) / KC;
  return n < 2 ? 2 : (n + 1) / 2 * 2;
}

// 2D tensor-map load (TMA) of the box at (x = innermost, y) into `dst`,
// completing on `bar`
FRT_DEV void tma_load_2d(void* dst, const void* tmap, int x, int y, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(
          smem_u32(dst)),
      "l"(tmap), "r"(smem_u32(bar)), "r"(x), "r"(y)
      : "memory");
}

// Raise a kernel's dynamic shared memory limit to the block maximum, once
// per kernel (the launches then ask for what they need).
template <auto kern>
inline cudaError_t allow_max_smem() {
  static const cudaError_t err = [] {
    cudaFuncAttributes a;
    const cudaError_t e = cudaFuncGetAttributes(&a, kern);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                227 * 1024 - (int)a.sharedSizeBytes);
  }();
  return err;
}

// ---- B operand images ----------------------------------------------------------

// Image of the (R x K) matrices src[b] (element (r, k) at b*sb + r*sr + k*sc),
// zero-padded to G 8-row groups and nchunks chunks of KC columns; per
// utterance, element (chunk, g, cm, r8, e) sits at
// (((chunk * G + g) * (KC / epc) + cm) * 8 + r8) * epc + e.  float input:
// TF32 hi (and, with lo non-null, lo) parts as float bit patterns; bf16
// input: one bf16 image (exact).
template <typename Tin>
__global__ void image_kernel(const Tin* __restrict__ src, long sb, long sr, long sc, int B, int R,
                             int K, int KC, int nchunks, int G, void* __restrict__ hi,
                             void* __restrict__ lo) {
  constexpr int epc = 16 / sizeof(Tin);
  const int cmc = KC / epc;
  const long per_b = (long)nchunks * G * cmc * 8 * epc;
  const long n = per_b * B;
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n; i += (long)gridDim.x * blockDim.x) {
    long j = i;
    const int e = j % epc;
    j /= epc;
    const int r8 = j % 8;
    j /= 8;
    const int cm = j % cmc;
    j /= cmc;
    const int g = j % G;
    j /= G;
    const int chunk = j % nchunks;
    const int b = j / nchunks;
    const int r = g * 8 + r8, k = chunk * KC + cm * epc + e;
    if constexpr (sizeof(Tin) == 2) {
      const Tin v = (r < R && k < K) ? src[b * sb + r * sr + k * sc] : Tin(0.f);
      static_cast<Tin*>(hi)[i] = v;
    } else {
      const float v = (r < R && k < K) ? src[b * sb + r * sr + k * sc] : 0.f;
      uint32_t h, l;
      split_tf32(v, h, l);
      static_cast<uint32_t*>(hi)[i] = h;
      if (lo != nullptr) static_cast<uint32_t*>(lo)[i] = l;
    }
  }
}

// Launch image_kernel for every utterance's (R x K) matrix; returns the
// launch's error.
template <typename Tin>
inline cudaError_t launch_image(const Tin* src, long sb, long sr, long sc, int B, int R, int K,
                                int KC, int nchunks, int G, void* hi, void* lo, cudaStream_t st) {
  const long n = (long)B * nchunks * G * 8 * KC;
  if (n == 0) return cudaSuccess;
  const long blocks = (n + 255) / 256;
  image_kernel<Tin><<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, st>>>(
      src, sb, sr, sc, B, R, K, KC, nchunks, G, hi, lo);
  return cudaGetLastError();
}

}  // namespace frt
