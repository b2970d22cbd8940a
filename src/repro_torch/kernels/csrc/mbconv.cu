// Two-pass fused MBConv kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the three Pallas TPU kernels of the JAX package's MBConv path
// (src/repro/kernels/convdk_mbconv.py):
//
//   mbconv_pass1_kernel            <- _mbconv_pass1_kernel            (:118)
//   mbconv_pool_reduce_kernel      <- the cross-strip SE pool sum of
//                                     _mbconv_pass1_kernel            (:151-163)
//   mbconv_pass2_recompute_kernel  <- _mbconv_pass2_recompute_kernel  (:169)
//   mbconv_pass2_retain_kernel     <- _mbconv_pass2_retain_kernel     (:220)
//
// What they compute (NHWC activations, w_exp (C_in, C_mid), w_dw
// (k, k, C_mid), w_proj (C_mid, C_out), all fp32):
//
//   pass 1     expand 1x1 (reduce C_in) -> exp_act -> k x k / s depthwise
//              -> dw_act; per-tile SE pool partial sums, and under retain
//              the DW tensor (B, out_h, out_w, C_mid).
//   pool       sums the per-tile partials in a fixed order (no atomics, so
//              results repeat bit for bit from run to run).
//   recompute  expand + DW again, x SE gate, projection 1x1 (reduce C_mid).
//   retain     re-read the DW tensor, x SE gate, projection 1x1.
//
// Design on this card.  The Pallas grids reduce over *sequential* grid
// steps (c_in innermost, c_mid for the projection, strips for the pool);
// CTAs have no order, so the c_in and c_mid reductions loop inside one CTA
// and the pool goes through per-tile partials plus a second kernel.  A
// full-width expanded strip does not fit 227 KB of shared memory, so each
// CTA owns a tile_h x tile_w output tile (at most MAXP pixels) and one
// 32-channel tile, with a halo on every side of its input window.  SAME
// padding is a bounds mask: an input pixel outside the image is read as 0,
// so its expanded value is exp_act(0), exactly what the JAX kernel's
// zero-padded input gives.  Ragged channel and spatial edges are masked
// here; the wrapper pads nothing.
//
// Bound.  fp32 FMA on CUDA cores, no tensor cores (the JAX suite's 1e-4
// fp32 bar).  At B0 widths the expand and projection contractions make
// pass 1 and recompute bound by operations once the halo recompute is
// counted; retain and the pool reduce move bytes.  Lane = channel keeps
// every global access of a warp on 128 contiguous bytes; the expand reads
// its input pixel as float4 broadcasts and keeps a 32-deep slice of w_exp
// in registers, so the inner loop issues one load per four FMAs; the
// projection reads the DW tile from shared memory as float4 broadcasts
// into per-thread accumulators.  Making them fast (wgmma, TMA, warp
// specialisation) is later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CT = 32;                  // channel tile: one lane per channel
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXP = 64;                // output pixels per CTA tile
constexpr int PPW = MAXP / NWARPS;      // output pixels per warp

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

struct Geom {
  int B, H, W, C_in, C_mid, C_out;
  int out_h, out_w, pad_top, pad_left;
  int tile_h, tile_w, n_tw, in_rows, in_cols;
};

// Expand 1x1 (reduce over C_in) + exp_act over the halo'd input window of
// one output tile, channel tile [cm0, cm0 + CT), into e_s[q * CT + lane].
// identity != 0 skips the contraction (expand ratio 1: w_exp = I).
__device__ void expand_window(const float* __restrict__ x,
                              const float* __restrict__ w_exp, float* e_s,
                              const Geom& g, int b, int ih0, int iw0, int cm0,
                              int identity, int exp_act) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cm = cm0 + lane;
  const bool m_ok = cm < g.C_mid;
  const int Q = g.in_rows * g.in_cols;
  if (identity) {
    for (int q = warp; q < Q; q += NWARPS) {
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      float v = 0.f;
      if (m_ok && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        v = __ldg(x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + cm);
      e_s[q * CT + lane] = act_apply(v, exp_act);
    }
    return;
  }
  for (int ci0 = 0; ci0 < g.C_in; ci0 += CT) {
    const int nci = min(CT, g.C_in - ci0);
    const bool last = ci0 + CT >= g.C_in;
    float w[CT];
#pragma unroll
    for (int t = 0; t < CT; ++t)
      w[t] = (m_ok && t < nci) ? __ldg(w_exp + (size_t)(ci0 + t) * g.C_mid + cm) : 0.f;
    for (int q = warp; q < Q; q += NWARPS) {
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      float acc = ci0 == 0 ? 0.f : e_s[q * CT + lane];
      if (ih >= 0 && ih < g.H && iw >= 0 && iw < g.W) {
        const float4* xp = reinterpret_cast<const float4*>(
            x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0);
#pragma unroll
        for (int t = 0; t < CT / 4; ++t) {
          if (4 * t < nci) {
            const float4 v = __ldg(xp + t);
            acc = fmaf(v.x, w[4 * t], acc);
            acc = fmaf(v.y, w[4 * t + 1], acc);
            acc = fmaf(v.z, w[4 * t + 2], acc);
            acc = fmaf(v.w, w[4 * t + 3], acc);
          }
        }
      }
      e_s[q * CT + lane] = last ? act_apply(acc, exp_act) : acc;
    }
  }
}

template <int K>
__device__ __forceinline__ void load_dw_taps(const float* __restrict__ w_dw,
                                             float (&wd)[K * K], int C_mid,
                                             int cm) {
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wd[t] = cm < C_mid ? __ldg(w_dw + (size_t)t * C_mid + cm) : 0.f;
}

// k x k / s depthwise taps of output pixel (pr, pc) of the tile, one lane.
template <int K, int S>
__device__ __forceinline__ float dw_at(const float* e_s, const float (&wd)[K * K],
                                       int pr, int pc, int in_cols, int lane) {
  float d = 0.f;
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < K; ++i)
      d = fmaf(e_s[((pr * S + j) * in_cols + pc * S + i) * CT + lane], wd[j * K + i], d);
  return d;
}

// acc[t] += sum_m d_s[p_t][m] * w_proj[cm0 + m][co0 + lane], p_t = warp + t * NWARPS.
__device__ __forceinline__ void project_tile(const float* d_s,
                                             const float* __restrict__ w_proj,
                                             float (&acc)[PPW], const Geom& g,
                                             int cm0, int co0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  const bool o_ok = co < g.C_out;
  const int P = g.tile_h * g.tile_w;
#pragma unroll
  for (int mm = 0; mm < CT; mm += 4) {
    float w4[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int cm = cm0 + mm + u;
      w4[u] = (o_ok && cm < g.C_mid) ? __ldg(w_proj + (size_t)cm * g.C_out + co) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < PPW; ++t) {
      const int p = warp + t * NWARPS;
      if (p < P) {
        const float4 d = *reinterpret_cast<const float4*>(d_s + p * CT + mm);
        acc[t] = fmaf(d.x, w4[0], acc[t]);
        acc[t] = fmaf(d.y, w4[1], acc[t]);
        acc[t] = fmaf(d.z, w4[2], acc[t]);
        acc[t] = fmaf(d.w, w4[3], acc[t]);
      }
    }
  }
}

__device__ __forceinline__ void write_tile(float* __restrict__ out,
                                           const float (&acc)[PPW], const Geom& g,
                                           int b, int oh0, int ow0, int co0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int co = co0 + lane;
  if (co >= g.C_out) return;
#pragma unroll
  for (int t = 0; t < PPW; ++t) {
    const int p = warp + t * NWARPS;
    if (p >= g.tile_h * g.tile_w) continue;
    const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
    if (oh < g.out_h && ow < g.out_w)
      out[((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out + co] = acc[t];
  }
}

// grid (n_tiles, ceil(C_mid / CT), B).  pool_partial (B, n_tiles, C_mid) or
// null (se off); dw_out (B, out_h, out_w, C_mid) or null (recompute).
template <int K, int S>
__global__ void __launch_bounds__(NTHREADS)
mbconv_pass1_kernel(const float* __restrict__ x, const float* __restrict__ w_exp,
                    const float* __restrict__ w_dw, float* __restrict__ pool_partial,
                    float* __restrict__ dw_out, Geom g, int identity, int exp_act,
                    int dw_act) {
  extern __shared__ float4 smem4[];
  float* e_s = reinterpret_cast<float*>(smem4);
  float* red_s = e_s + g.in_rows * g.in_cols * CT;
  const int tile = blockIdx.x, cm0 = blockIdx.y * CT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cm = cm0 + lane;

  expand_window(x, w_exp, e_s, g, b, oh0 * S - g.pad_top, ow0 * S - g.pad_left,
                cm0, identity, exp_act);
  float wd[K * K];
  load_dw_taps<K>(w_dw, wd, g.C_mid, cm);
  __syncthreads();

  float psum = 0.f;
  if (cm < g.C_mid) {
    for (int p = warp; p < g.tile_h * g.tile_w; p += NWARPS) {
      const int pr = p / g.tile_w, pc = p % g.tile_w;
      const int oh = oh0 + pr, ow = ow0 + pc;
      if (oh >= g.out_h || ow >= g.out_w) continue;  // masked rows and columns
      const float d = act_apply(dw_at<K, S>(e_s, wd, pr, pc, g.in_cols, lane), dw_act);
      psum += d;
      if (dw_out) dw_out[((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_mid + cm] = d;
    }
  }
  if (pool_partial) {
    red_s[warp * CT + lane] = psum;
    __syncthreads();
    if (warp == 0 && cm < g.C_mid) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) s += red_s[w * CT + lane];
      pool_partial[((size_t)b * gridDim.x + tile) * g.C_mid + cm] = s;
    }
  }
}

// One thread per (b, c): sums the n_tiles partials in tile order.
__global__ void mbconv_pool_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ pool, int B,
                                          int n_tiles, int C) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i % C;
  const float* p = partial + (size_t)b * n_tiles * C + c;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += p[(size_t)t * C];
  pool[i] = s;
}

// grid (n_tiles, ceil(C_out / CT), B).  gate (B, C_mid) or null (se off).
template <int K, int S>
__global__ void __launch_bounds__(NTHREADS)
mbconv_pass2_recompute_kernel(const float* __restrict__ x, const float* __restrict__ w_exp,
                              const float* __restrict__ w_dw, const float* __restrict__ gate,
                              const float* __restrict__ w_proj, float* __restrict__ out,
                              Geom g, int identity, int exp_act, int dw_act) {
  extern __shared__ float4 smem4[];
  float* e_s = reinterpret_cast<float*>(smem4);
  float* d_s = e_s + g.in_rows * g.in_cols * CT;   // MAXP x CT
  const int tile = blockIdx.x, co0 = blockIdx.y * CT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = g.tile_h * g.tile_w;

  float acc[PPW];
#pragma unroll
  for (int t = 0; t < PPW; ++t) acc[t] = 0.f;

  for (int cm0 = 0; cm0 < g.C_mid; cm0 += CT) {
    const int cm = cm0 + lane;
    const bool m_ok = cm < g.C_mid;
    expand_window(x, w_exp, e_s, g, b, oh0 * S - g.pad_top, ow0 * S - g.pad_left,
                  cm0, identity, exp_act);
    float wd[K * K];
    load_dw_taps<K>(w_dw, wd, g.C_mid, cm);
    const float scale = (gate && m_ok) ? __ldg(gate + (size_t)b * g.C_mid + cm) : 1.f;
    __syncthreads();
    for (int p = warp; p < MAXP; p += NWARPS) {
      float d = 0.f;
      if (p < P && m_ok) {
        const int pr = p / g.tile_w, pc = p % g.tile_w;
        if (oh0 + pr < g.out_h && ow0 + pc < g.out_w)
          d = act_apply(dw_at<K, S>(e_s, wd, pr, pc, g.in_cols, lane), dw_act) * scale;
      }
      d_s[p * CT + lane] = d;
    }
    __syncthreads();
    project_tile(d_s, w_proj, acc, g, cm0, co0);
    __syncthreads();
  }
  write_tile(out, acc, g, b, oh0, ow0, co0);
}

// grid (n_tiles, ceil(C_out / CT), B).  dw (B, out_h, out_w, C_mid).
__global__ void __launch_bounds__(NTHREADS)
mbconv_pass2_retain_kernel(const float* __restrict__ dw, const float* __restrict__ gate,
                           const float* __restrict__ w_proj, float* __restrict__ out,
                           Geom g) {
  __shared__ float4 d_s4[MAXP * CT / 4];
  float* d_s = reinterpret_cast<float*>(d_s4);
  const int tile = blockIdx.x, co0 = blockIdx.y * CT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int P = g.tile_h * g.tile_w;

  float acc[PPW];
#pragma unroll
  for (int t = 0; t < PPW; ++t) acc[t] = 0.f;

  for (int cm0 = 0; cm0 < g.C_mid; cm0 += CT) {
    const int cm = cm0 + lane;
    const bool m_ok = cm < g.C_mid;
    const float scale = (gate && m_ok) ? __ldg(gate + (size_t)b * g.C_mid + cm) : 1.f;
    for (int p = warp; p < MAXP; p += NWARPS) {
      float d = 0.f;
      if (p < P && m_ok) {
        const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
        if (oh < g.out_h && ow < g.out_w)
          d = __ldg(dw + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_mid + cm) * scale;
      }
      d_s[p * CT + lane] = d;
    }
    __syncthreads();
    project_tile(d_s, w_proj, acc, g, cm0, co0);
    __syncthreads();
  }
  write_tile(out, acc, g, b, oh0, ow0, co0);
}

Geom make_geom(int B, int H, int W, int C_in, int C_mid, int C_out, int K, int S,
               int out_h, int out_w, int pad_top, int pad_left, int tile_h, int tile_w) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_mid = C_mid; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w;
  g.n_tw = (out_w + tile_w - 1) / tile_w;
  g.in_rows = (tile_h - 1) * S + K;
  g.in_cols = (tile_w - 1) * S + K;
  return g;
}

int n_tiles(const Geom& g) {
  return ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
}

bool geom_ok(const Geom& g) {
  return g.B > 0 && g.C_in > 0 && g.C_mid > 0 && g.C_out > 0 && g.out_h > 0 &&
         g.out_w > 0 && g.tile_h > 0 && g.tile_w > 0 && g.tile_h * g.tile_w <= MAXP &&
         g.C_in % 4 == 0 && g.B <= 65535;
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

// Raises a kernel's dynamic shared-memory cap to the card's maximum.  The
// launchers call it once per kernel instance (a function-local static), so
// no attribute call lands inside a CUDA graph capture.
template <typename Kern>
cudaError_t set_max_smem(Kern kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
}

template <int K, int S>
cudaError_t launch_pass1(const float* x, const float* w_exp, const float* w_dw,
                         float* pool_partial, float* dw_out, const Geom& g,
                         int identity, int exp_act, int dw_act, cudaStream_t stream) {
  const size_t smem = (size_t)(g.in_rows * g.in_cols + NWARPS) * CT * sizeof(float);
  static const cudaError_t smem_set = set_max_smem(mbconv_pass1_kernel<K, S>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_mid + CT - 1) / CT, g.B);
  mbconv_pass1_kernel<K, S><<<grid, NTHREADS, smem, stream>>>(
      x, w_exp, w_dw, pool_partial, dw_out, g, identity, exp_act, dw_act);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_recompute(const float* x, const float* w_exp, const float* w_dw,
                             const float* gate, const float* w_proj, float* out,
                             const Geom& g, int identity, int exp_act, int dw_act,
                             cudaStream_t stream) {
  const size_t smem = (size_t)(g.in_rows * g.in_cols + MAXP) * CT * sizeof(float);
  static const cudaError_t smem_set = set_max_smem(mbconv_pass2_recompute_kernel<K, S>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_out + CT - 1) / CT, g.B);
  mbconv_pass2_recompute_kernel<K, S><<<grid, NTHREADS, smem, stream>>>(
      x, w_exp, w_dw, gate, w_proj, out, g, identity, exp_act, dw_act);
  return cudaGetLastError();
}

}  // namespace

// Instantiates EXPR (which names KK and SS) for each supported (K, S).
#define MBCONV_KS_SWITCH(K_, S_, ...)                                       \
  switch ((K_) * 10 + (S_)) {                                               \
    case 31: { constexpr int KK = 3, SS = 1; return (int)(__VA_ARGS__); }   \
    case 32: { constexpr int KK = 3, SS = 2; return (int)(__VA_ARGS__); }   \
    case 51: { constexpr int KK = 5, SS = 1; return (int)(__VA_ARGS__); }   \
    case 52: { constexpr int KK = 5, SS = 2; return (int)(__VA_ARGS__); }   \
    default: return (int)cudaErrorInvalidValue;                             \
  }

// The C interface, bound with ctypes.  Each call launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int mbconv_channel_tile() { return CT; }
int mbconv_max_tile_pixels() { return MAXP; }
const char* mbconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int mbconv_pass1(const float* x, const float* w_exp, const float* w_dw,
                 float* pool_partial, float* dw_out, int B, int H, int W, int C_in,
                 int C_mid, int K, int S, int out_h, int out_w, int pad_top,
                 int pad_left, int tile_h, int tile_w, int identity, int exp_act,
                 int dw_act, void* stream) {
  const Geom g = make_geom(B, H, W, C_in, C_mid, 1, K, S, out_h, out_w, pad_top,
                           pad_left, tile_h, tile_w);
  if (!geom_ok(g)) return (int)cudaErrorInvalidValue;
  MBCONV_KS_SWITCH(K, S, launch_pass1<KK, SS>(x, w_exp, w_dw, pool_partial, dw_out, g,
                                              identity, exp_act, dw_act,
                                              (cudaStream_t)stream))
}

int mbconv_pool_reduce(const float* partial, float* pool, int B, int n_tiles, int C,
                       void* stream) {
  if (B <= 0 || n_tiles <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256, blocks = (B * C + threads - 1) / threads;
  mbconv_pool_reduce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      partial, pool, B, n_tiles, C);
  return (int)cudaGetLastError();
}

int mbconv_pass2_recompute(const float* x, const float* w_exp, const float* w_dw,
                           const float* gate, const float* w_proj, float* out, int B,
                           int H, int W, int C_in, int C_mid, int C_out, int K, int S,
                           int out_h, int out_w, int pad_top, int pad_left, int tile_h,
                           int tile_w, int identity, int exp_act, int dw_act,
                           void* stream) {
  const Geom g = make_geom(B, H, W, C_in, C_mid, C_out, K, S, out_h, out_w, pad_top,
                           pad_left, tile_h, tile_w);
  if (!geom_ok(g)) return (int)cudaErrorInvalidValue;
  MBCONV_KS_SWITCH(K, S, launch_recompute<KK, SS>(x, w_exp, w_dw, gate, w_proj, out, g,
                                                  identity, exp_act, dw_act,
                                                  (cudaStream_t)stream))
}

int mbconv_pass2_retain(const float* dw, const float* gate, const float* w_proj,
                        float* out, int B, int out_h, int out_w, int C_mid, int C_out,
                        int tile_h, int tile_w, void* stream) {
  // the retained-DW stream has no halo: a 1 x 1 / 1 window geometry
  const Geom g = make_geom(B, out_h, out_w, 4, C_mid, C_out, 1, 1, out_h, out_w, 0, 0,
                           tile_h, tile_w);
  if (!geom_ok(g)) return (int)cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (C_out + CT - 1) / CT, B);
  mbconv_pass2_retain_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      dw, gate, w_proj, out, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
