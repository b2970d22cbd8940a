// bf16 tensor-core helpers of the MBConv, Fused-MBConv and fused separable
// kernels (mbconv.cu, fusedmb.cu, separable.cu), which only their bf16
// builds call: ldmatrix
// loads, the m16n8k16 bf16 product with fp32 sums, and the exact
// three-term bf16 split of an fp32 operand.
//
// mma.sync m16n8k16 with fp32 accumulation, its operands loaded from
// shared memory by ldmatrix: every row address 16-byte aligned, and row
// strides an odd multiple of 16 bytes, so the 8 rows of each 8x8 matrix
// fall in 8 different bank groups.  A fragment register holds two
// neighbouring elements of one row, the lower column in the low half; for
// lane l, register r of an A (16 x 16) fragment holds row l / 4 + 8 (r & 1)
// at columns 2 (l % 4) + 8 (r >> 1) + {0, 1}, and an accumulator holds
// rows l / 4 (c0, c1) and l / 4 + 8 (c2, c3) at columns 2 (l % 4) + {0, 1}.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MMA_M = 16;               // rows of one m16n8k16 product

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// four 8x8 b16 matrices; lanes 8 i .. 8 i + 7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ... transposed: from a K x N row-major tile, the col-major B fragments
__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// ... two of them (one k16 x n8 B fragment); lanes 0 .. 15 address the rows
__device__ __forceinline__ void ldsm_x2_trans(unsigned (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// d += a (16 x 16, bf16) * b (16 x 8, bf16), fp32 sums.  Registers only, so
// not volatile: the compiler may interleave independent products.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float2 unpack_bf16x2(unsigned r) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r));
}

// a0 == hi + mid + lo exactly (and a1 likewise), three bf16 terms of 8
// significant bits each, fp32's 24 together, packed in pairs as an mma
// operand register (a0 in the low half), for a == 0 and every finite
// |a| >= 2^-110.  Each term truncates: hi keeps a's top 16 bits (sign,
// exponent, 7 stored significand bits: a bf16), so hi has a's sign and
// exponent and r = a - hi is exact (Sterbenz), a multiple of a's fp32 ulp
// below hi's last bit (at most 16 bits); mid keeps r's top 16 bits the same
// way, and r - mid, exact again, has at most 8 bits left, which a bf16
// holds: lo.  Masks, subtractions and byte permutes only, no conversion
// instructions (a quarter of the FMA rate).  kernels/common.py's
// bf16x3_split is its plain twin.  __fsub_rn is never contracted.
__device__ __forceinline__ void bf16x3_split2(float a0, float a1, unsigned& hi, unsigned& mid,
                                              unsigned& lo) {
  constexpr unsigned TOP = 0xffff0000u;
  const unsigned u0 = __float_as_uint(a0), u1 = __float_as_uint(a1);
  const float r0 = __fsub_rn(a0, __uint_as_float(u0 & TOP));
  const float r1 = __fsub_rn(a1, __uint_as_float(u1 & TOP));
  const unsigned v0 = __float_as_uint(r0), v1 = __float_as_uint(r1);
  const float l0 = __fsub_rn(r0, __uint_as_float(v0 & TOP));
  const float l1 = __fsub_rn(r1, __uint_as_float(v1 & TOP));
  hi = __byte_perm(u0, u1, 0x7632);     // the top halves of the two words
  mid = __byte_perm(v0, v1, 0x7632);
  lo = __byte_perm(__float_as_uint(l0), __float_as_uint(l1), 0x7632);
}

}  // namespace
