// Tensor-core primitives shared by the port's kernels for Hopper
// (sm_90a): the bf16 flash-attention kernels (flash_attention_tc.cuh), the
// fp32 flash backward (flash_attention_bwd.cu), the fused bottleneck in
// bf16 and fp32 (fused_bottleneck_tc.cuh, fused_bottleneck.cu) and the
// dequant-matmul (dequant_matmul.cu).
//
// Fragment layouts (PTX ISA, lane = 4 * g + t).  mma.m16n8k16 (bf16): an
// fp32 accumulator holds rows g and g + 8, columns 2t and 2t + 1; an A
// operand holds rows g, g + 8 and columns 2t, 2t + 1, 2t + 8, 2t + 9;
// a B operand columns (n) g and rows (k) 2t, 2t + 1, 2t + 8, 2t + 9.
// mma.m16n8k8 (tf32): the accumulator as above; A holds (g, t), (g + 8,
// t), (g, t + 4), (g + 8, t + 4) in a[0..3]; B holds (k t, n g) and (k
// t + 4, n g) in b0, b1.
//
// fp32 accuracy on the TF32 tensor cores (3xTF32): each fp32 operand x is
// split into big = rna_tf32(x) and small = x - big (split_tf32), and a
// product accumulates small.big, big.small, big.big in fp32 (small.small,
// ~2^-22 of the product, is dropped), so a product carries ~2^-20
// relative error against fp32's 2^-24 per rounding and one-pass TF32's
// 2^-11.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace paddle_tc {

typedef __nv_bfloat16 bf16;

// bf16 elements of padding per staged row: rows stay 16-byte aligned, and
// the 8 row addresses of an ldmatrix phase fall in distinct bank groups
// when the row is an odd number of 16-byte units long
constexpr int kSkew = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16, 8 or 4 bytes global -> shared, asynchronously; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 bf16 matrices from shared memory; lane l gives the address
// of row (l & 7) of matrix l >> 3.  With .trans each matrix arrives
// transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] . b[16 x 8], bf16 in, fp32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to a bf16 pair, lo in the low half (a NaN stays
// NaN)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// max(v, 0) that keeps a NaN v, as torch.relu and the JAX kernel's
// jnp.maximum do (fmaxf(v, 0.f) returns 0 for it): a compare and a select
__device__ __forceinline__ float relu(float v) {
  return (v > 0.f || v != v) ? v : 0.f;
}

// one fp32 value as its TF32 big and small parts.  big is x rounded to
// nearest TF32, ties away (cvt.rna.tf32.f32's result for finite x, by
// integer add and mask where the compiler emulates cvt in four
// instructions); small is the exact remainder x - big, of which the
// tensor core reads the TF32 top 19 bits (truncated: |error| <= 2^-10
// |small| <= 2^-21 |x|).
//
// kClamp (the default) clamps the rounding at the largest finite TF32 of
// x's sign (+-0x1.ffcp127, M below): a signed integer min against
// 0x7f7fffff, or 0xff7fffff for a negative x (a more negative float is a
// larger negative integer), before the mask.  So big is never infinite:
//   * a finite x within half a TF32 ulp of FLT_MAX gets big = M (x
//     truncated) and an exact small;
//   * x = +-inf gets big = +-M and small = x - big = +-inf, never inf -
//     inf; each product small.big + big.small + big.big with a finite y
//     is then +-inf . big_y = +-inf (big_y has y's sign) plus finite
//     terms, +-inf where x . y is, and NaN where x . y is (y = 0).  The
//     term M . small_y stays finite while |small_y| <= 1, i.e. |y| < 2^12;
//     past that, as for two finite operands whose product overflows by
//     2^11 or more, the terms may overflow with opposite signs to NaN;
//   * a NaN x stays NaN in small (big is M or +-0).
// Five instructions (the bound is formed beside the add).
//
// Without kClamp, three: an x of |x| >= 0x1.ffep127 (within half a TF32
// ulp of FLT_MAX, or infinite) gets an infinite big and a NaN or infinite
// small of the other sign, and every product with it — small.big +
// big.small + big.big with any y — is NaN; every other x splits as with
// kClamp.  A kernel that splits streamed operands at each fragment load
// (fp32 K1 and K2) runs a block unclamped first and, when the block's
// results hold a NaN, runs it again clamped: a block whose results hold
// none met no such operand (or only where its product is masked
// anyway), so it computed what the clamped split computes.
template <bool kClamp = true>
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  const uint32_t u = __float_as_uint(x);
  if constexpr (kClamp)
    big = (uint32_t)min((int)(u + 0x1000u),
                        (int)((u & 0x80000000u) | 0x7f7fffffu)) &
          0xffffe000u;
  else
    big = (u + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// c[16 x 8] += a[16 x 8] . b[8 x 8], tf32 in, fp32 accumulators (not
// volatile: the compiler may interleave independent products)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A split operand: the big and small TF32 parts of an A (x4) or B (x2)
// fragment
struct SplitA {
  uint32_t big[4], small[4];
};
struct SplitB {
  uint32_t big[2], small[2];
};

template <bool kClamp = true>
__device__ __forceinline__ void split_a(SplitA& s, float a0, float a1,
                                        float a2, float a3) {
  split_tf32<kClamp>(a0, s.big[0], s.small[0]);
  split_tf32<kClamp>(a1, s.big[1], s.small[1]);
  split_tf32<kClamp>(a2, s.big[2], s.small[2]);
  split_tf32<kClamp>(a3, s.big[3], s.small[3]);
}

template <bool kClamp = true>
__device__ __forceinline__ void split_b(SplitB& s, float b0, float b1) {
  split_tf32<kClamp>(b0, s.big[0], s.small[0]);
  split_tf32<kClamp>(b1, s.big[1], s.small[1]);
}

// One of the three products of c += a . b at fp32 accuracy: pass 0
// small.big, 1 big.small, 2 big.big, accumulated in that order (the
// smallest terms first).  Callers run a pass over all their independent
// accumulators before the next pass (`pass` a constant after unrolling),
// so that no product waits on the one before it.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const SplitA& a,
                                           const SplitB& b, int pass) {
  if (pass == 0)
    mma_tf32(c, a.small, b.big[0], b.big[1]);
  else if (pass == 1)
    mma_tf32(c, a.big, b.small[0], b.small[1]);
  else
    mma_tf32(c, a.big, b.big[0], b.big[1]);
}

}  // namespace paddle_tc
