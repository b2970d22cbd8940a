// The split-K fold of the MBConv and separable kernels (mbconv.cu,
// separable.cu).  Where a launch splits its reduction over the grid (retain
// and recompute over C_mid, the fp32 fused separable kernel over C_in; the
// bf16 one sums its splits in a cluster's shared memory instead), every
// CTA writes its fp32 partial of its output tile, counts itself in at the
// tile's arrival counter, and the CTA that arrives last reads the tile's
// partials back through L2 and sums them in split order,
// ((p0 + p1) + p2) + ..., applies the epilogue and writes the output once,
// rounded once to its type.  The counter only elects that CTA: no value is
// ever added atomically, so the output repeats bit for bit and equals the
// plain split-order sum of the partials the same launch wrote.
//
// The counters are one zeroed int buffer per device, shared by pass 1's SE
// pool and these folds; the last CTA resets its counter to 0, so the buffer
// is ready for the next launch and for CUDA graph replays.  One stream at a
// time uses it, as the port does.
//
// The last CTA's sum is a read of splits x (tile) fp32 values through one
// SM, so it keeps several items' loads of several splits in flight per
// thread (16-byte loads where the tile's columns come in fours), as many
// as the kernel's registers allow: the fold must not raise the kernel's
// register count above its main loop's, or fewer CTAs fit an SM.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>

#include "storage.cuh"

namespace {

// atomicAdd with acquire-release semantics at device scope.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

// One thread's arrival for its CTA, after a barrier that orders the CTA's
// partial stores before it: the atomic's release publishes them, its
// acquire makes the partials of the CTAs counted before it visible.  True
// for the last of `arrivals` CTAs, which resets the counter to 0.  (A
// __threadfence() before a relaxed atomic, the textbook form, was slower
// on the card in pass 1: PERF.md.)
__device__ __forceinline__ bool count_in(int* ctr, int arrivals) {
  const bool last = atomic_add_acq_rel(ctr, 1) == arrivals - 1;
  if (last) *ctr = 0;
  return last;
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
}

// The last CTA's sum over rows [0, rows) of its tile: row r's `width`
// columns sit at element offset row_at(r) of out and of each split's
// partial (partial + z * zstride), or nowhere where row_at(r) < 0; columns
// at or past `valid` are skipped.  out = epi(((p0 + p1) + p2) + ...),
// rounded once to T.  `tid` of `nthreads` summing threads; each loads
// its ITEMS items' p0, then keeps their loads of ZU splits in flight.
// (Loading p0 within the first ZU splits' round ran slower on the card.)  vec: 4 columns an item,
// 16-byte loads and one 4-wide store (width, valid, every offset and
// zstride multiples of 4); else one column an item.  Partials are read
// with __ldcg (L2), never the read-only path, which is not coherent with
// the other CTAs' stores of this launch.
template <int ITEMS, int ZU, typename T, typename RowAt, typename Epi>
__device__ __forceinline__ void fold_tile(const float* __restrict__ partial,
                                          T* __restrict__ out, size_t zstride, int splits,
                                          int rows, int width, int valid, bool vec, int tid,
                                          int nthreads, RowAt row_at, Epi epi) {
  if (vec) {
    const int groups = width / 4, n = rows * groups;
    for (int i0 = tid; i0 < n; i0 += ITEMS * nthreads) {
      long long at[ITEMS];
      float4 s[ITEMS];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int i = i0 + u * nthreads, c = 4 * (i % groups);
        const long long row = i < n && c < valid ? row_at(i / groups) : -1;
        at[u] = row >= 0 ? row + c : -1;
        s[u] = at[u] >= 0 ? __ldcg(reinterpret_cast<const float4*>(partial + at[u]))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      for (int z0 = 1; z0 < splits; z0 += ZU) {
        float4 v[ZU][ITEMS];
#pragma unroll
        for (int z = 0; z < ZU; ++z)
#pragma unroll
          for (int u = 0; u < ITEMS; ++u)
            if (z0 + z < splits && at[u] >= 0)
              v[z][u] = __ldcg(reinterpret_cast<const float4*>(
                  partial + (size_t)(z0 + z) * zstride + at[u]));
#pragma unroll
        for (int z = 0; z < ZU; ++z)
#pragma unroll
          for (int u = 0; u < ITEMS; ++u)
            if (z0 + z < splits && at[u] >= 0) add4(s[u], v[z][u]);
      }
#pragma unroll
      for (int u = 0; u < ITEMS; ++u)
        if (at[u] >= 0) st4(out + at[u], epi(s[u].x), epi(s[u].y), epi(s[u].z), epi(s[u].w));
    }
  } else {
    const int n = rows * width;
    for (int i0 = tid; i0 < n; i0 += ITEMS * nthreads) {
      long long at[ITEMS];
      float s[ITEMS];
#pragma unroll
      for (int u = 0; u < ITEMS; ++u) {
        const int i = i0 + u * nthreads, c = i % width;
        const long long row = i < n && c < valid ? row_at(i / width) : -1;
        at[u] = row >= 0 ? row + c : -1;
        s[u] = at[u] >= 0 ? __ldcg(partial + at[u]) : 0.f;
      }
      for (int z0 = 1; z0 < splits; z0 += ZU) {
        float v[ZU][ITEMS];
#pragma unroll
        for (int z = 0; z < ZU; ++z)
#pragma unroll
          for (int u = 0; u < ITEMS; ++u)
            if (z0 + z < splits && at[u] >= 0)
              v[z][u] = __ldcg(partial + (size_t)(z0 + z) * zstride + at[u]);
#pragma unroll
        for (int z = 0; z < ZU; ++z)
#pragma unroll
          for (int u = 0; u < ITEMS; ++u)
            if (z0 + z < splits && at[u] >= 0) s[u] += v[z][u];
      }
#pragma unroll
      for (int u = 0; u < ITEMS; ++u)
        if (at[u] >= 0) out[at[u]] = from_f<T>(epi(s[u]));
    }
  }
}

}  // namespace
