// Storage-type helpers of the MBConv and Fused-MBConv kernels (mbconv.cu,
// fusedmb.cu): their activations and weights are float or __nv_bfloat16
// (T), their sums fp32.  Conversions between fp32 and T, cp.async copies
// of T into shared memory (which move bytes unconverted), and 4-channel
// loads and stores that convert on the way: one 16-byte access in fp32,
// one 8-byte access in bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// conversions: fp32 to and from the storage type (rounded to nearest even)
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// cp.async copies of 16, 8 or 4 bytes; bytes past src_bytes are
// zero-filled (src_bytes 0 reads nothing, so src need only be a valid
// address).
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(src_bytes));
}

// 4 elements of T from src, the first n of them valid (0 <= n <= 4; src
// aligned to the copy), the rest zero: one 16-byte (fp32) or 8-byte (bf16)
// copy.
template <typename T>
__device__ __forceinline__ void cp4(T* dst, const T* src, int n) {
  cp_async<(int)(4 * sizeof(T))>(dst, src, n * (int)sizeof(T));
}

// One element of T, or zero where !ok: a 4-byte copy in fp32, a plain load
// and store in bf16 (cp.async copies no fewer than 4 bytes).
template <typename T>
__device__ __forceinline__ void cp1(T* dst, const T* src, bool ok) {
  if constexpr (sizeof(T) == 4)
    cp_async<4>(dst, src, ok ? 4 : 0);
  else
    *dst = ok ? *src : from_f<T>(0.f);
}

template <typename T>
__device__ __forceinline__ float ldg_f(const T* p) { return to_f(__ldg(p)); }

// 4 elements of T at p (aligned: 16 bytes in fp32, 8 in bf16) as fp32
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4 fp32 values to p, each rounded once to T: one 16-byte or 8-byte store
__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float a, float b, float c, float d) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a, b), hi = __floats2bfloat162_rn(c, d);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&lo);
  raw.y = *reinterpret_cast<const unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// The first min(n, 4) of 4 fp32 sums to p, rounded once to its type: one
// vector store where vec (p aligned to it), else one element at a time.
template <typename T>
__device__ __forceinline__ void store_row(T* p, const float (&v)[4], bool vec, int n) {
  if (vec) {
    st4(p, v[0], v[1], v[2], v[3]);
  } else {
    for (int u = 0; u < 4 && u < n; ++u) p[u] = from_f<T>(v[u]);
  }
}

}  // namespace
