// Depthwise-separable kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the two Pallas TPU kernels of the JAX package's separable path:
//
//   fused_separable_kernel <- _fused_kernel (src/repro/kernels/convdk_fused.py:59),
//                             launched by fused_separable_pallas (:120)
//   dw2d_kernel            <- _dw2d_kernel (src/repro/kernels/convdk_dw.py:32),
//                             launched by dw2d_pallas (:57)
//
// What they compute (NHWC activations, w_dw (k, k, C) taps, w_pw (C_in, C_out),
// all fp32):
//
//   fused_separable  depthwise k x k / s -> dw_act -> pointwise 1x1 (reduce
//                    C_in) -> act, in one launch: the DW output never reaches
//                    device memory, the block output is written once.
//   dw2d             depthwise k x k / s over pre-staged overlapping row strips
//                    (B, n_th, in_rows, W_pad, C) -> (B, n_th, tile_h, out_w, C),
//                    the staged baseline's DW stage (the strips are written to
//                    device memory by the wrapper, as the paper's baseline pays).
//
// Design of fused_separable.  The Pallas grid (b, strip, c_out-blk, c_in-blk)
// carries the pointwise reduction across sequential c_in steps in a VMEM
// accumulator; CTAs have no order, so the reduction loops inside one CTA.  A
// CTA owns one batch element, one tile_h x tile_w output tile (at most MAXP
// pixels) and one c_out tile of COT channels (32, 64 or 128, the smallest
// covering C_out).  For each 32-wide c_in chunk it stages the halo'd input
// window, the chunk's taps and the (32, COT) pointwise slice in shared memory,
// computes the depthwise conv + dw_act into a (pixels, 32) shared tile (2
// pixels x 4 channels per thread, the taps read as float4) and adds that
// tile's product with the pointwise slice into per-thread register
// accumulators.  act is applied and the output written once at the end.  This
// is fusedmb.cu's structure with the dense conv replaced by a depthwise one.
// The depthwise is recomputed per c_out tile, as the Pallas grid does
// (c_out-blk outside c_in-blk): past 128 output channels that is 2-3x its
// k*k FMAs per channel, against C_out FMAs per channel for the pointwise.
//
// Design of dw2d.  One CTA per (channel block of 32, strip, batch element);
// each thread keeps the k*k taps of its 4 channels in registers and walks
// the strip's output pixels, reading the strips straight from device memory
// (float4 along C when C % 4 == 0, else scalar loads) and writing each
// output once.  The k*k re-reads of each input hit L1/L2.
//
// SAME padding is a bounds mask in fused_separable (an input pixel outside
// the image reads as 0; stride 2 puts the extra pad at the bottom/right, the
// wrapper passes the top/left pads); dw2d gets padded strips.  Ragged pixel
// and channel edges are masked here in both; the wrappers pad no channel.
//
// Bound.  On MobileNet-V2 at 224 fused_separable is bound by bytes on the
// 112x112 to 28x28 blocks and by operations (C_in C_out FMAs per output
// pixel) on the 14x14 and 7x7 ones; dw2d does k*k FMAs per 8 bytes moved
// and is bound by bytes.  fp32 FMA on
// CUDA cores, no tensor cores and no TF32 (the JAX suite's 1e-4 fp32 bar).
// TMA, cp.async pipelining and wgmma are later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CT = 32;                  // c_in chunk (fused), channel block (dw2d)
constexpr int NTHREADS = 256;
constexpr int MAXP = 64;                // output pixels per fused CTA tile
constexpr int XS = CT + 4;              // floats per staged pixel (padded)
constexpr int NCG = CT / 4;             // 4-channel groups of a chunk
constexpr int NPG = NTHREADS / NCG;     // fused DW: pixel groups (2 pixels each)
static_assert(NPG * 2 == MAXP, "each fused DW thread owns 2 pixels");

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

// acc[0..3] += a * w.{x,y,z,w}
__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// ------------------------------- fused_separable -------------------------------

struct Geom {
  int B, H, W, C_in, C_out;
  int out_h, out_w, pad_top, pad_left;
  int tile_h, tile_w, n_tw, in_rows, in_cols;
};

// the c_out tile of one CTA: the smallest of 32, 64, 128 covering C_out
int co_tile(int C_out) { return C_out <= 32 ? 32 : C_out <= 64 ? 64 : 128; }

size_t smem_floats(int K, int in_rows, int in_cols, int COT) {
  return (size_t)(in_rows * in_cols + MAXP) * XS + (size_t)K * K * CT + (size_t)CT * COT;
}

// grid (n_tiles, ceil(C_out / COT), B), NTHREADS threads.
template <int K, int S, int COT>
__global__ void __launch_bounds__(NTHREADS, 2)
fused_separable_kernel(const float* __restrict__ x, const float* __restrict__ w_dw,
                       const float* __restrict__ w_pw, float* __restrict__ out, Geom g,
                       int dw_act, int act) {
  constexpr int OCG = COT / 4;          // pointwise: 4-channel groups
  constexpr int OPG = NTHREADS / OCG;   // pointwise: pixel groups
  constexpr int PPT = MAXP / OPG;       // pointwise: pixels per thread

  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);       // in_rows*in_cols x XS
  float* e_s = x_s + g.in_rows * g.in_cols * XS;      // MAXP x XS
  float* wd_s = e_s + MAXP * XS;                      // (K*K) x CT
  float* wp_s = wd_s + K * K * CT;                    // CT x COT

  const int tile = blockIdx.x, co0 = blockIdx.y * COT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x;
  const int P = g.tile_h * g.tile_w;
  const int Q = g.in_rows * g.in_cols;

  // DW role: channels 4 * cg .. + 3 of the c_in chunk, pixels pg, pg + NPG
  const int cg = t % NCG, pg = t / NCG;
  int xoff[2];                          // window pixel of each pixel's (0, 0) tap
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = pg + NPG * j;
    xoff[j] = p < P ? (p / g.tile_w) * S * g.in_cols + (p % g.tile_w) * S : 0;
  }
  // pointwise role: channels co0 + 4 * og .. + 3, pixels opg + OPG * j
  const int og = t % OCG, opg = t / OCG;
  float acc[PPT][4];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;

  const float4* x4 = reinterpret_cast<const float4*>(x_s);
  const float4* wd4 = reinterpret_cast<const float4*>(wd_s);
  const float4* e4 = reinterpret_cast<const float4*>(e_s);
  const float4* p4 = reinterpret_cast<const float4*>(wp_s) + og;
  for (int ci0 = 0; ci0 < g.C_in; ci0 += CT) {
    const int nci = min(CT, g.C_in - ci0);
    __syncthreads();                    // the last chunk's readers are done
    // the halo'd input window, channels [ci0, ci0 + CT), 0 off the image
    for (int i = t; i < Q * CT; i += NTHREADS) {
      const int q = i / CT, ci = i % CT;
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      float v = 0.f;
      if (ci < nci && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
        v = __ldg(x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + ci);
      x_s[q * XS + ci] = v;
    }
    // w_dw[:, :, ci0:ci0+CT] as rows (tap) of CT channels
    for (int i = t; i < K * K * CT; i += NTHREADS) {
      const int tap = i / CT, ci = i % CT;
      wd_s[i] = ci < nci ? __ldg(w_dw + (size_t)tap * g.C_in + ci0 + ci) : 0.f;
    }
    // w_pw[ci0:ci0+CT, co0:co0+COT]
    for (int i = t; i < CT * COT; i += NTHREADS) {
      const int m = i / COT, o = i % COT;
      float v = 0.f;
      if (m < nci && co0 + o < g.C_out)
        v = __ldg(w_pw + (size_t)(ci0 + m) * g.C_out + co0 + o);
      wp_s[i] = v;
    }
    __syncthreads();
    // depthwise over the window, 2 pixels x 4 channels per thread
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const float4 w = wd4[(kh * K + kw) * NCG + cg];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float4 v = x4[(xoff[j] + kh * g.in_cols + kw) * (XS / 4) + cg];
          d[j][0] = fmaf(v.x, w.x, d[j][0]);
          d[j][1] = fmaf(v.y, w.y, d[j][1]);
          d[j][2] = fmaf(v.z, w.z, d[j][2]);
          d[j][3] = fmaf(v.w, w.w, d[j][3]);
        }
      }
    }
    // dw_act; channels past C_in are 0 (dw_act(0) need not be)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int c = 4 * cg;
      float4 v;
      v.x = c < nci ? act_apply(d[j][0], dw_act) : 0.f;
      v.y = c + 1 < nci ? act_apply(d[j][1], dw_act) : 0.f;
      v.z = c + 2 < nci ? act_apply(d[j][2], dw_act) : 0.f;
      v.w = c + 3 < nci ? act_apply(d[j][3], dw_act) : 0.f;
      reinterpret_cast<float4*>(e_s + (pg + NPG * j) * XS)[cg] = v;
    }
    __syncthreads();
    // pointwise: this chunk's (pixels, 32) tile x w_pw slice
#pragma unroll 2
    for (int m4 = 0; m4 < CT / 4; ++m4) {
      const float4 w0 = p4[(4 * m4) * OCG], w1 = p4[(4 * m4 + 1) * OCG];
      const float4 w2 = p4[(4 * m4 + 2) * OCG], w3 = p4[(4 * m4 + 3) * OCG];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const float4 e = e4[(opg + OPG * j) * (XS / 4) + m4];
        fma4(acc[j], e.x, w0);
        fma4(acc[j], e.y, w1);
        fma4(acc[j], e.z, w2);
        fma4(acc[j], e.w, w3);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int p = opg + OPG * j;
    if (p >= P) continue;
    const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
    if (oh >= g.out_h || ow >= g.out_w) continue;
    float* o = out + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int co = co0 + 4 * og + u;
      if (co < g.C_out) o[co] = act_apply(acc[j][u], act);
    }
  }
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

template <int K, int S, int COT>
cudaError_t launch_fused(const float* x, const float* w_dw, const float* w_pw,
                         float* out, const Geom& g, int dw_act, int act,
                         cudaStream_t stream) {
  const size_t smem = smem_floats(K, g.in_rows, g.in_cols, COT) * sizeof(float);
  // once per instance (a function-local static), so no attribute call lands
  // inside a CUDA graph capture
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      fused_separable_kernel<K, S, COT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  const dim3 grid(n_tiles, (g.C_out + COT - 1) / COT, g.B);
  fused_separable_kernel<K, S, COT><<<grid, NTHREADS, smem, stream>>>(
      x, w_dw, w_pw, out, g, dw_act, act);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_fused_co(const float* x, const float* w_dw, const float* w_pw,
                            float* out, const Geom& g, int dw_act, int act,
                            cudaStream_t stream) {
  switch (co_tile(g.C_out)) {
    case 32: return launch_fused<K, S, 32>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    case 64: return launch_fused<K, S, 64>(x, w_dw, w_pw, out, g, dw_act, act, stream);
    default: return launch_fused<K, S, 128>(x, w_dw, w_pw, out, g, dw_act, act, stream);
  }
}

// ------------------------------------ dw2d ------------------------------------

constexpr int DW_NPL = NTHREADS / NCG;  // pixel lanes of a dw2d CTA

struct StripGeom {
  int n_th, in_rows, W_pad, C, tile_h, out_w;
};

// x[0..3] of 4 channels at a (16-byte aligned when VEC) address; scalar
// loads of the first n otherwise
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

// grid (ceil(C / CT), n_th, B), NTHREADS threads; VEC when C % 4 == 0.
template <int K, int S, bool VEC>
__global__ void __launch_bounds__(NTHREADS)
dw2d_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ out, StripGeom g) {
  const int t = threadIdx.x;
  const int c = blockIdx.x * CT + 4 * (t % NCG);
  if (c >= g.C) return;                 // no barrier below
  const int n = min(4, g.C - c);
  const int lane = t / NCG;
  float4 taps[K * K];
#pragma unroll
  for (int tap = 0; tap < K * K; ++tap) taps[tap] = load4<VEC>(w + (size_t)tap * g.C + c, n);
  const size_t strip = (size_t)blockIdx.z * g.n_th + blockIdx.y;
  const float* xs = x + strip * g.in_rows * g.W_pad * g.C + c;
  float* os = out + strip * g.tile_h * g.out_w * g.C + c;
  const int npix = g.tile_h * g.out_w;
  for (int p = lane; p < npix; p += DW_NPL) {
    const int r = p / g.out_w, ow = p % g.out_w;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const float* row = xs + ((size_t)(r * S + kh) * g.W_pad + ow * S) * g.C;
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
    float* o = os + (size_t)p * g.C;
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(o) = acc;
    } else {
      o[0] = acc.x;
      if (n > 1) o[1] = acc.y;
      if (n > 2) o[2] = acc.z;
      if (n > 3) o[3] = acc.w;
    }
  }
}

template <int K, int S>
cudaError_t launch_dw2d(const float* x, const float* w, float* out, int B,
                        const StripGeom& g, cudaStream_t stream) {
  const dim3 grid((g.C + CT - 1) / CT, g.n_th, B);
  if (g.C % 4 == 0)
    dw2d_kernel<K, S, true><<<grid, NTHREADS, 0, stream>>>(x, w, out, g);
  else
    dw2d_kernel<K, S, false><<<grid, NTHREADS, 0, stream>>>(x, w, out, g);
  return cudaGetLastError();
}

}  // namespace

// The C interface, bound with ctypes.  Each launcher launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int separable_channel_tile() { return CT; }
int separable_max_tile_pixels() { return MAXP; }
int separable_pixel_stride() { return XS; }
// the dynamic shared memory one fused_separable launch asks for (the
// schedule solver's budget check must agree with it)
size_t fused_separable_smem_bytes(int K, int in_rows, int in_cols, int C_out) {
  return smem_floats(K, in_rows, in_cols, co_tile(C_out)) * sizeof(float);
}
const char* separable_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fused_separable(const float* x, const float* w_dw, const float* w_pw, float* out,
                    int B, int H, int W, int C_in, int C_out, int K, int S, int out_h,
                    int out_w, int pad_top, int pad_left, int tile_h, int tile_w,
                    int dw_act, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w;
  if (B <= 0 || B > 65535 || C_in <= 0 || C_out <= 0 || out_h <= 0 || out_w <= 0 ||
      tile_h <= 0 || tile_w <= 0 || tile_h * tile_w > MAXP)
    return (int)cudaErrorInvalidValue;
  g.n_tw = (out_w + tile_w - 1) / tile_w;
  g.in_rows = (tile_h - 1) * S + K;
  g.in_cols = (tile_w - 1) * S + K;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K * 10 + S) {
    case 31: return (int)launch_fused_co<3, 1>(x, w_dw, w_pw, out, g, dw_act, act, st);
    case 32: return (int)launch_fused_co<3, 2>(x, w_dw, w_pw, out, g, dw_act, act, st);
    case 51: return (int)launch_fused_co<5, 1>(x, w_dw, w_pw, out, g, dw_act, act, st);
    case 52: return (int)launch_fused_co<5, 2>(x, w_dw, w_pw, out, g, dw_act, act, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dw2d(const float* x_strips, const float* w, float* out, int B, int n_th,
         int in_rows, int W_pad, int C, int K, int S, int tile_h, int out_w,
         void* stream) {
  StripGeom g;
  g.n_th = n_th; g.in_rows = in_rows; g.W_pad = W_pad; g.C = C;
  g.tile_h = tile_h; g.out_w = out_w;
  if (B <= 0 || B > 65535 || n_th <= 0 || n_th > 65535 || C <= 0 || tile_h <= 0 ||
      out_w <= 0 || in_rows != (tile_h - 1) * S + K || W_pad < (out_w - 1) * S + K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K * 10 + S) {
    case 31: return (int)launch_dw2d<3, 1>(x_strips, w, out, B, g, st);
    case 32: return (int)launch_dw2d<3, 2>(x_strips, w, out, B, g, st);
    case 51: return (int)launch_dw2d<5, 1>(x_strips, w, out, B, g, st);
    case 52: return (int)launch_dw2d<5, 2>(x_strips, w, out, B, g, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
