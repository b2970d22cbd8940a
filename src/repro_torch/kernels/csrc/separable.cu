// Depthwise-separable kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the two Pallas TPU kernels of the JAX package's separable path:
//
//   fused_separable_kernel <- _fused_kernel (src/repro/kernels/convdk_fused.py:59),
//                             launched by fused_separable_pallas (:120)
//   fused_separable_reduce_kernel <- the c_in accumulation across grid steps
//                             inside _fused_kernel (:59)
//   dw2d_kernel            <- _dw2d_kernel (src/repro/kernels/convdk_dw.py:32),
//                             launched by dw2d_pallas (:57)
//
// What they compute (NHWC activations, w_dw (k, k, C) taps, w_pw (C_in, C_out)):
//
//   fused_separable  depthwise k x k / s -> dw_act -> pointwise 1x1 (reduce
//                    C_in) -> act, fp32, in one launch (two where C_in is
//                    split): the DW output never reaches device memory.
//   dw2d             depthwise k x k / s over pre-staged overlapping row strips
//                    (B, n_th, in_rows, W_pad, C) -> (B, n_th, tile_h, out_w, C),
//                    fp32 or bf16 in and out with fp32 sums, the staged
//                    baseline's DW stage (the strips are written to device
//                    memory by the wrapper, as the paper's baseline pays).
//
// Design of fused_separable.  The Pallas grid (b, strip, c_out-blk, c_in-blk)
// carries the pointwise reduction across sequential c_in steps in a VMEM
// accumulator; CTAs have no order.  A CTA owns one batch element, one
// tile_h x tile_w output tile (at most MAXP pixels), one c_out tile of NC
// channels and one split of C_in: a run of whole CI-channel chunks.  The
// chunks stream through a three-slot cp.async ring (the halo'd input window
// of the chunk, its taps and its (CI, NC) pointwise rows), loaded one chunk
// ahead of the depthwise that reads them.  Per chunk the CTA computes the
// depthwise conv + dw_act into one half of a double-buffered (pixels, CI)
// shared tile (one pixel x 4 channels per item, the taps read as float4)
// while the previous chunk's half is multiplied into register accumulators
// with fusedmb.cu's GEMM step (4 pixels x NC / LC channels per thread):
// one barrier per chunk, since at MobileNet-V2's widths a chunk is a few
// microseconds of work and its barriers and latencies weigh as much as its
// FMAs.  The late MobileNet-V2
// blocks (28x28 / s2 to 7x7) have too few pixels to fill 132 SMs, so the
// solver (core.autotune.select_fused_schedule) picks small tiles and splits
// C_in across CTAs: each split writes its fp32 partial product and
// fused_separable_reduce_kernel (B4') sums the partials in split order,
// applies act and writes the output (no atomics: results repeat bit for
// bit).  The splits are bounded by splits * C_out < C_in, so the partials
// move fewer bytes than the depthwise tensor the staged route writes.  Where
// C_in is not split the CTA applies act and writes the output itself.  The
// depthwise is recomputed per c_out tile, as the Pallas grid does (c_out-blk
// outside c_in-blk): k*k FMAs per channel, against NC for the pointwise.
//
// Design of dw2d.  One CTA per (channel block of 32, strip, batch element);
// each thread keeps the k*k taps of its 4 channels in registers and walks
// the strip's output pixels, reading the strips straight from device memory
// (one 16-byte fp32 or 8-byte bf16 load per 4 channels when C % 4 == 0,
// else scalar loads) and writing each output once, rounded once from the
// fp32 sum.  The k*k re-reads of each input hit L1/L2.
//
// SAME padding is a bounds mask in fused_separable (cp.async zero-fills an
// input pixel outside the image; stride 2 puts the extra pad at the
// bottom/right, the wrapper passes the top/left pads); dw2d gets padded
// strips.  Ragged pixel and channel edges are masked here in both; the
// wrappers pad no channel.
//
// Bound.  On MobileNet-V2 at 224 fused_separable is bound by bytes on the
// 112x112 to 28x28 blocks and by operations (C_in C_out FMAs per output
// pixel) on the 14x14 and 7x7 ones; at batch 8 every block is a few
// microseconds of work, so CTA start-up and per-chunk latency weigh as
// much as either.  dw2d does k*k FMAs per 8 (fp32) or 4 (bf16) bytes moved
// and is bound by bytes.  fp32 FMA on CUDA cores, no tensor cores and no
// TF32 (the JAX suite's 1e-4 fp32 bar).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CT = 32;                  // channel block of dw2d
constexpr int NTHREADS = 256;           // dw2d
constexpr int NCG = CT / 4;             // 4-channel groups of a dw2d block

enum Act {
  ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_SILU = 3, ACT_SIGMOID = 4,
  ACT_HARD_SWISH = 5, ACT_HARD_SIGMOID = 6
};

__device__ __forceinline__ float act_apply(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_RELU6: return fminf(fmaxf(v, 0.f), 6.f);
    case ACT_SILU: return v * (1.f / (1.f + expf(-v)));
    case ACT_SIGMOID: return 1.f / (1.f + expf(-v));
    case ACT_HARD_SWISH: return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
    case ACT_HARD_SIGMOID: return fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
    default: return v;
  }
}

// ------------------------------- fused_separable -------------------------------

constexpr int MAXP = 64;                // output pixels per CTA tile
constexpr int CI = 32;                  // c_in chunk per ring slot
constexpr int XS = CI + 4;              // floats per staged pixel (float4 stride odd)
constexpr int TP = 4;                   // pointwise pixels per thread
constexpr int SLOTS = 3;                // cp.async ring: two chunks in flight
constexpr int FS_THREADS = 128;

// channel lanes of a warp at c_out tile NC (fusedmb.cu's layout)
__host__ __device__ constexpr int chunk_lanes(int NC) {
  return NC == 16 ? 4 : NC == 24 ? 2 : NC == 32 ? 4 : NC == 48 ? 4 : NC == 64 ? 8 : 0;
}
__host__ __device__ constexpr int pixels_per_warp(int NC) { return TP * 32 / chunk_lanes(NC); }

struct Geom {
  int B, H, W, C_in, C_out;
  int out_h, out_w, pad_top, pad_left;
  int tile_h, tile_w, n_tw, in_rows, in_cols;
  int n_co, splits, split_chunks;       // c_out tiles, C_in splits, chunks per split
};

// cp.async copies of 16 or 4 bytes; bytes past src_bytes are zero-filled
// (src_bytes 0 reads nothing, so src need only be a valid address).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[j][c] += sum_k a[j][k] * b[k][c] over n4 * 4 rows k (fusedmb.cu's
// GEMM step): a row j at a_s + aoff[j], b row k at b_s + k * NC
template <int NC>
__device__ __forceinline__ void gemm_step(float (&acc)[TP][NC / chunk_lanes(NC)],
                                          const float* __restrict__ a_s,
                                          const int (&aoff)[TP],
                                          const float* __restrict__ b_s, int lc, int n4) {
  constexpr int LC = chunk_lanes(NC), TC = NC / LC;
  const float* b0 = b_s + 4 * lc;
#pragma unroll 2
  for (int c4 = 0; c4 < n4; ++c4) {
    float4 a[TP];
#pragma unroll
    for (int j = 0; j < TP; ++j)
      a[j] = *reinterpret_cast<const float4*>(a_s + aoff[j] + 4 * c4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = b0 + (4 * c4 + kk) * NC;
#pragma unroll
      for (int u = 0; u < TC / 4; ++u) {
        const float4 b = *reinterpret_cast<const float4*>(brow + 4 * LC * u);
#pragma unroll
        for (int j = 0; j < TP; ++j) {
          const float av = comp(a[j], kk);
          acc[j][4 * u] = fmaf(av, b.x, acc[j][4 * u]);
          acc[j][4 * u + 1] = fmaf(av, b.y, acc[j][4 * u + 1]);
          acc[j][4 * u + 2] = fmaf(av, b.z, acc[j][4 * u + 2]);
          acc[j][4 * u + 3] = fmaf(av, b.w, acc[j][4 * u + 3]);
        }
      }
    }
  }
}

// one ring slot: the window (Q x XS), the taps (K*K x CI), the pointwise
// rows (CI x NC); then two (pixels, CI) depthwise tiles
__host__ __device__ size_t slot_floats(int K, int in_rows, int in_cols, int NC) {
  return (size_t)in_rows * in_cols * XS + (size_t)K * K * CI + (size_t)CI * NC;
}

size_t smem_floats(int K, int in_rows, int in_cols, int pixels, int NC) {
  return SLOTS * slot_floats(K, in_rows, in_cols, NC) + 2 * (size_t)pixels * XS;
}

// grid (n_tiles, n_co * splits, B), FS_THREADS threads.  With splits > 1
// out is the (splits, B, out_h, out_w, C_out) partial buffer and act is
// ACT_NONE (the reduce applies it).
template <int K, int S, int NC>
__global__ void __launch_bounds__(FS_THREADS, 4)
fused_separable_kernel(const float* __restrict__ x, const float* __restrict__ w_dw,
                       const float* __restrict__ w_pw, float* __restrict__ out, Geom g,
                       int dw_act, int act) {
  constexpr int LC = chunk_lanes(NC), TC = NC / LC, LP = 32 / LC;
  constexpr int PPW = pixels_per_warp(NC);
  constexpr int KK = K * K;

  const int P = g.tile_h * g.tile_w, Q = g.in_rows * g.in_cols;
  const int slot = (int)slot_floats(K, g.in_rows, g.in_cols, NC);
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);      // SLOTS x slot
  float* e_s = ring + SLOTS * slot;                   // 2 x P x XS

  const int tile = blockIdx.x, b = blockIdx.z;
  const int co0 = (blockIdx.y % g.n_co) * NC, split = blockIdx.y / g.n_co;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x, warp = t / 32;
  const int lane = t % 32, lp = lane / LC, lc = lane % LC;
  const int pw_warps = (P + PPW - 1) / PPW;
  const int n_chunks = (g.C_in + CI - 1) / CI;
  const int c_lo = split * g.split_chunks;
  const int c_hi = min(n_chunks, c_lo + g.split_chunks);
  const bool vec_i = g.C_in % 4 == 0, vec_o = g.C_out % 4 == 0;

  // chunk c (channels [CI * c, + CI), 0 past C_in) into ring slot s
  auto stage = [&](int c, int s) {
    float* xw = ring + s * slot;
    float* taps = xw + Q * XS;
    float* pw = taps + KK * CI;
    const int ci0 = c * CI;
    for (int e = t; e < Q * (CI / 4); e += FS_THREADS) {
      const int q = e / (CI / 4), ch = 4 * (e % (CI / 4));
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const float* src = x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + ch;
      float* dst = xw + q * XS + ch;
      if (vec_i) {
        const bool ok = in && ci0 + ch < g.C_in;
        cp_async16(dst, ok ? src : x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = in && ci0 + ch + u < g.C_in;
          cp_async4(dst + u, ok ? src + u : x, ok ? 4 : 0);
        }
      }
    }
    for (int e = t; e < KK * (CI / 4); e += FS_THREADS) {
      const int tap = e / (CI / 4), ch = 4 * (e % (CI / 4));
      const float* src = w_dw + (size_t)tap * g.C_in + ci0 + ch;
      if (vec_i) {
        const bool ok = ci0 + ch < g.C_in;
        cp_async16(taps + tap * CI + ch, ok ? src : w_dw, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = ci0 + ch + u < g.C_in;
          cp_async4(taps + tap * CI + ch + u, ok ? src + u : w_dw, ok ? 4 : 0);
        }
      }
    }
    for (int e = t; e < CI * (NC / 4); e += FS_THREADS) {
      const int r = e / (NC / 4), col = 4 * (e % (NC / 4));
      const float* src = w_pw + (size_t)(ci0 + r) * g.C_out + co0 + col;
      if (vec_o) {
        const bool ok = ci0 + r < g.C_in && co0 + col < g.C_out;
        cp_async16(pw + r * NC + col, ok ? src : w_pw, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = ci0 + r < g.C_in && co0 + col + u < g.C_out;
          cp_async4(pw + r * NC + col + u, ok ? src + u : w_pw, ok ? 4 : 0);
        }
      }
    }
  };

  // the pointwise role: pixels warp * PPW + lp + LP * j (a pixel past the
  // tile reads pixel P - 1 and is never written)
  int eoff[TP];
#pragma unroll
  for (int j = 0; j < TP; ++j) eoff[j] = min(warp * PPW + lp + LP * j, P - 1) * XS;
  float acc[TP][TC];
#pragma unroll
  for (int j = 0; j < TP; ++j)
#pragma unroll
    for (int u = 0; u < TC; ++u) acc[j][u] = 0.f;

  // chunk c's depthwise + dw_act into its half of the depthwise tile, one
  // pixel x 4 channels per item; channels past C_in are 0 (dw_act(0) need
  // not be)
  auto depthwise = [&](int c) {
    const float* xw = ring + ((c - c_lo) % SLOTS) * slot;
    const float* taps = xw + Q * XS;
    float* e = e_s + ((c - c_lo) % 2) * P * XS;
    const int nci = min(CI, g.C_in - c * CI);
    for (int i = t; i < P * (CI / 4); i += FS_THREADS) {
      const int p = i / (CI / 4), ch = 4 * (i % (CI / 4));
      const float* xp = xw + ((p / g.tile_w) * S * g.in_cols + (p % g.tile_w) * S) * XS + ch;
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4 v = *reinterpret_cast<const float4*>(xp + (kh * g.in_cols + kw) * XS);
          const float4 w = *reinterpret_cast<const float4*>(taps + (kh * K + kw) * CI + ch);
          d.x = fmaf(v.x, w.x, d.x);
          d.y = fmaf(v.y, w.y, d.y);
          d.z = fmaf(v.z, w.z, d.z);
          d.w = fmaf(v.w, w.w, d.w);
        }
      }
      d.x = ch < nci ? act_apply(d.x, dw_act) : 0.f;
      d.y = ch + 1 < nci ? act_apply(d.y, dw_act) : 0.f;
      d.z = ch + 2 < nci ? act_apply(d.z, dw_act) : 0.f;
      d.w = ch + 3 < nci ? act_apply(d.w, dw_act) : 0.f;
      *reinterpret_cast<float4*>(e + p * XS + ch) = d;
    }
  };

  // SLOTS - 1 chunks ahead (empty groups past the split keep the count)
  for (int c = c_lo; c < c_lo + SLOTS - 1; ++c) {
    if (c < c_hi) stage(c, c - c_lo);
    cp_async_commit();
  }
  cp_async_wait<SLOTS - 2>();
  __syncthreads();                      // chunk c_lo landed
  depthwise(c_lo);
  // one barrier per chunk: chunk c + 1's depthwise and chunk c's pointwise
  // share a phase (the depthwise tile is double-buffered)
  for (int c = c_lo; c < c_hi; ++c) {
    cp_async_wait<0>();
    __syncthreads();                    // chunk c + 1 landed; depthwise(c) written; chunk c - 1 read
    if (c + SLOTS - 1 < c_hi) stage(c + SLOTS - 1, (c + SLOTS - 1 - c_lo) % SLOTS);
    cp_async_commit();
    if (c + 1 < c_hi) depthwise(c + 1);
    if (warp < pw_warps) {
      const float* pw = ring + ((c - c_lo) % SLOTS) * slot + Q * XS + KK * CI;
      gemm_step<NC>(acc, e_s + ((c - c_lo) % 2) * P * XS, eoff, pw, lc, CI / 4);
    }
  }

  if (warp >= pw_warps) return;
  float* o_base = out + (size_t)split * g.B * g.out_h * g.out_w * g.C_out;
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    const int p = warp * PPW + lp + LP * j;
    if (p >= P) continue;
    const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
    if (oh >= g.out_h || ow >= g.out_w) continue;
    float* o = o_base + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out;
#pragma unroll
    for (int u = 0; u < TC / 4; ++u) {
      const int co = co0 + 4 * lc + 4 * LC * u;
      if (vec_o && co < g.C_out) {
        *reinterpret_cast<float4*>(o + co) =
            make_float4(act_apply(acc[j][4 * u], act), act_apply(acc[j][4 * u + 1], act),
                        act_apply(acc[j][4 * u + 2], act), act_apply(acc[j][4 * u + 3], act));
      } else if (!vec_o) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (co + v < g.C_out) o[co + v] = act_apply(acc[j][4 * u + v], act);
      }
    }
  }
}

// B4': out[i] = act(sum over s of part[s][i]), s in order; float4 when n %
// 4 == 0.  Grid-stride over n elements (n4 float4s).
template <bool VEC>
__global__ void __launch_bounds__(256)
fused_separable_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                              long long n, int splits, int act) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if constexpr (VEC) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    float4* o4 = reinterpret_cast<float4*>(out);
    const long long n4 = n / 4;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
      float4 a = __ldg(p4 + i);
      for (int s = 1; s < splits; ++s) {
        const float4 v = __ldg(p4 + (long long)s * n4 + i);
        a.x += v.x;
        a.y += v.y;
        a.z += v.z;
        a.w += v.w;
      }
      o4[i] = make_float4(act_apply(a.x, act), act_apply(a.y, act), act_apply(a.z, act),
                          act_apply(a.w, act));
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
      float a = __ldg(part + i);
      for (int s = 1; s < splits; ++s) a += __ldg(part + (long long)s * n + i);
      out[i] = act_apply(a, act);
    }
  }
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

template <int K, int S, int NC>
cudaError_t launch_fused(const float* x, const float* w_dw, const float* w_pw,
                         float* out, const Geom& g, int dw_act, int act,
                         cudaStream_t stream) {
  const size_t smem =
      smem_floats(K, g.in_rows, g.in_cols, g.tile_h * g.tile_w, NC) * sizeof(float);
  // once per instance (a function-local static), so no attribute call lands
  // inside a CUDA graph capture
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      fused_separable_kernel<K, S, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  const dim3 grid(n_tiles, g.n_co * g.splits, g.B);
  fused_separable_kernel<K, S, NC><<<grid, FS_THREADS, smem, stream>>>(
      x, w_dw, w_pw, out, g, dw_act, act);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_fused_nc(const float* x, const float* w_dw, const float* w_pw,
                            float* out, const Geom& g, int nc, int dw_act, int act,
                            cudaStream_t stream) {
  switch (nc) {
    case 16: return launch_fused<K, S, 16>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    case 24: return launch_fused<K, S, 24>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    case 32: return launch_fused<K, S, 32>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    case 48: return launch_fused<K, S, 48>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    case 64: return launch_fused<K, S, 64>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------ dw2d ------------------------------------

constexpr int DW_NPL = NTHREADS / NCG;  // pixel lanes of a dw2d CTA

struct StripGeom {
  int n_th, in_rows, W_pad, C, tile_h, out_w;
};

// 4 channels at p as fp32: one 16-byte (fp32) or 8-byte (bf16) load when
// VEC (p aligned to it), else scalar loads of the first n
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* p, int n) {
  if constexpr (VEC) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = __ldg(p);
  if (n > 1) v.y = __ldg(p + 1);
  if (n > 2) v.z = __ldg(p + 2);
  if (n > 3) v.w = __ldg(p + 3);
  return v;
}

template <bool VEC>
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, int n) {
  if constexpr (VEC) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                       __high2float(hi));
  }
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  v.x = __bfloat162float(p[0]);
  if (n > 1) v.y = __bfloat162float(p[1]);
  if (n > 2) v.z = __bfloat162float(p[2]);
  if (n > 3) v.w = __bfloat162float(p[3]);
  return v;
}

// the first n of 4 fp32 sums to p, each rounded once to the element type
template <bool VEC>
__device__ __forceinline__ void store4(float* p, const float4& v, int n) {
  if constexpr (VEC) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    p[0] = v.x;
    if (n > 1) p[1] = v.y;
    if (n > 2) p[2] = v.z;
    if (n > 3) p[3] = v.w;
  }
}

template <bool VEC>
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4& v, int n) {
  if constexpr (VEC) {
    __nv_bfloat162 lo, hi;
    lo.x = __float2bfloat16_rn(v.x);
    lo.y = __float2bfloat16_rn(v.y);
    hi.x = __float2bfloat16_rn(v.z);
    hi.y = __float2bfloat16_rn(v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&lo);
    raw.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    p[0] = __float2bfloat16_rn(v.x);
    if (n > 1) p[1] = __float2bfloat16_rn(v.y);
    if (n > 2) p[2] = __float2bfloat16_rn(v.z);
    if (n > 3) p[3] = __float2bfloat16_rn(v.w);
  }
}

// grid (ceil(C / CT), n_th, B), NTHREADS threads; VEC when C % 4 == 0.  T is
// float or __nv_bfloat16 (x, taps and output alike); the sums are fp32.
template <int K, int S, bool VEC, typename T>
__global__ void __launch_bounds__(NTHREADS)
dw2d_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
            StripGeom g) {
  const int t = threadIdx.x;
  const int c = blockIdx.x * CT + 4 * (t % NCG);
  if (c >= g.C) return;                 // no barrier below
  const int n = min(4, g.C - c);
  const int lane = t / NCG;
  float4 taps[K * K];
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) taps[tap] = load4<VEC>(w + (size_t)tap * g.C + c, n);
  const size_t strip = (size_t)blockIdx.z * g.n_th + blockIdx.y;
  const T* xs = x + strip * g.in_rows * g.W_pad * g.C + c;
  T* os = out + strip * g.tile_h * g.out_w * g.C + c;
  const int npix = g.tile_h * g.out_w;
  for (int p = lane; p < npix; p += DW_NPL) {
    const int r = p / g.out_w, ow = p % g.out_w;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const T* row = xs + ((size_t)(r * S + kh) * g.W_pad + ow * S) * g.C;
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const float4 v = load4<VEC>(row + (size_t)kw * g.C, n);
        const float4 wt = taps[kh * K + kw];
        acc.x = fmaf(v.x, wt.x, acc.x);
        acc.y = fmaf(v.y, wt.y, acc.y);
        acc.z = fmaf(v.z, wt.z, acc.z);
        acc.w = fmaf(v.w, wt.w, acc.w);
      }
    }
    store4<VEC>(os + (size_t)p * g.C, acc, n);
  }
}

template <int K, int S, typename T>
cudaError_t launch_dw2d(const T* x, const T* w, T* out, int B, const StripGeom& g,
                        cudaStream_t stream) {
  const dim3 grid((g.C + CT - 1) / CT, g.n_th, B);
  if (g.C % 4 == 0)
    dw2d_kernel<K, S, true, T><<<grid, NTHREADS, 0, stream>>>(x, w, out, g);
  else
    dw2d_kernel<K, S, false, T><<<grid, NTHREADS, 0, stream>>>(x, w, out, g);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dw2d_k(const void* x, const void* w, void* out, int B, int K, int S,
                          const StripGeom& g, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  T* ot = static_cast<T*>(out);
  switch (K * 10 + S) {
    case 31: return launch_dw2d<3, 1, T>(xt, wt, ot, B, g, st);
    case 32: return launch_dw2d<3, 2, T>(xt, wt, ot, B, g, st);
    case 51: return launch_dw2d<5, 1, T>(xt, wt, ot, B, g, st);
    case 52: return launch_dw2d<5, 2, T>(xt, wt, ot, B, g, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface, bound with ctypes.  Each launcher launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int fused_separable_max_tile_pixels() { return MAXP; }
int fused_separable_ci_chunk() { return CI; }
int fused_separable_pixel_stride() { return XS; }
int fused_separable_threads() { return FS_THREADS; }
int fused_separable_chunk_lanes(int nc) { return chunk_lanes(nc); }
// the dynamic shared memory one fused_separable launch asks for (the
// schedule solver's budget check must agree with it)
size_t fused_separable_smem_bytes(int K, int in_rows, int in_cols, int pixels, int nc) {
  return smem_floats(K, in_rows, in_cols, pixels, nc) * sizeof(float);
}
const char* separable_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// out is the block output (splits 1) or the (splits, B, out_h, out_w,
// C_out) fp32 partials the reduce sums (splits > 1, act ignored)
int fused_separable(const float* x, const float* w_dw, const float* w_pw, float* out,
                    int B, int H, int W, int C_in, int C_out, int K, int S, int out_h,
                    int out_w, int pad_top, int pad_left, int tile_h, int tile_w, int nc,
                    int splits, int dw_act, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w;
  const int n_chunks = (C_in + CI - 1) / CI;
  if (B <= 0 || B > 65535 || C_in <= 0 || C_out <= 0 || out_h <= 0 || out_w <= 0 ||
      tile_h <= 0 || tile_w <= 0 || tile_h * tile_w > MAXP || chunk_lanes(nc) == 0 ||
      splits <= 0 || splits > n_chunks)
    return (int)cudaErrorInvalidValue;
  g.n_co = (C_out + nc - 1) / nc;
  g.split_chunks = (n_chunks + splits - 1) / splits;
  g.splits = splits;
  // every split sums at least one chunk
  if ((splits - 1) * g.split_chunks >= n_chunks || g.n_co * splits > 65535)
    return (int)cudaErrorInvalidValue;
  g.n_tw = (out_w + tile_w - 1) / tile_w;
  g.in_rows = (tile_h - 1) * S + K;
  g.in_cols = (tile_w - 1) * S + K;
  const int a = splits > 1 ? (int)ACT_NONE : act;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K * 10 + S) {
    case 31: return (int)launch_fused_nc<3, 1>(x, w_dw, w_pw, out, g, nc, dw_act, a, st);
    case 32: return (int)launch_fused_nc<3, 2>(x, w_dw, w_pw, out, g, nc, dw_act, a, st);
    case 51: return (int)launch_fused_nc<5, 1>(x, w_dw, w_pw, out, g, nc, dw_act, a, st);
    case 52: return (int)launch_fused_nc<5, 2>(x, w_dw, w_pw, out, g, nc, dw_act, a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// B4': out (n floats) = act(sum of the splits x n partials, in split order)
int fused_separable_reduce(const float* part, float* out, long long n, int splits, int act,
                           void* stream) {
  if (n <= 0 || splits <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const long long work = n % 4 == 0 ? n / 4 : n;
  const int grid = (int)((work + 255) / 256 < 132 * 16 ? (work + 255) / 256 : 132 * 16);
  if (n % 4 == 0)
    fused_separable_reduce_kernel<true><<<grid, 256, 0, st>>>(part, out, n, splits, act);
  else
    fused_separable_reduce_kernel<false><<<grid, 256, 0, st>>>(part, out, n, splits, act);
  return (int)cudaGetLastError();
}

// x_strips, w and out all fp32 (bf16 = 0) or all bf16 (bf16 = 1)
int dw2d(const void* x_strips, const void* w, void* out, int B, int n_th, int in_rows,
         int W_pad, int C, int K, int S, int tile_h, int out_w, int bf16, void* stream) {
  StripGeom g;
  g.n_th = n_th; g.in_rows = in_rows; g.W_pad = W_pad; g.C = C;
  g.tile_h = tile_h; g.out_w = out_w;
  if (B <= 0 || B > 65535 || n_th <= 0 || n_th > 65535 || C <= 0 || tile_h <= 0 ||
      out_w <= 0 || in_rows != (tile_h - 1) * S + K || W_pad < (out_w - 1) * S + K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch_dw2d_k<__nv_bfloat16>(x_strips, w, out, B, K, S, g, st)
                    : launch_dw2d_k<float>(x_strips, w, out, B, K, S, g, st));
}

}  // extern "C"
