// Single-pass Fused-MBConv kernel for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the Pallas TPU kernel of the JAX package's Fused-MBConv path
// (src/repro/kernels/convdk_fusedmb.py):
//
//   fusedmb_kernel  <- _fusedmb_kernel (:59), launched by fusedmb_pallas (:133)
//
// What it computes (NHWC activations, w_conv (k, k, C_in, C_mid) HWIO,
// w_proj (C_mid, C_out), all fp32), EfficientNet-V2's fused stages without
// the residual (the model layer adds it):
//
//   dense k x k / s conv (reduce C_in) -> act -> projection 1x1 (reduce C_mid)
//
// The expanded (C_mid) tensor never reaches device memory.
//
// Design on this card.  The Pallas grid (b, c_out-blk, strip, c_mid-blk,
// c_in-blk) carries both reductions across sequential grid steps in VMEM
// scratch; CTAs have no order, so both loop inside one CTA.  A CTA owns one
// batch element, one tile_h x tile_w pixel tile (at most MAXP pixels) and
// one c_out tile of COT channels (32, 64 or 128, the smallest covering
// C_out), so at EfficientNet-V2-S's widths (C_out <= 64) the dense conv is
// computed exactly once.  For each 32-wide c_mid chunk it accumulates the
// dense conv in registers over 32-wide c_in chunks (each step stages the
// halo'd input window and the (k, k, 32, 32) weight slice in shared
// memory), applies the activation, writes the (pixels, 32) tile to shared
// memory and adds its projection into per-thread register accumulators
// that the CTA keeps for its whole pixels x COT tile.  The output is
// written once at the end.
//
// SAME padding is a bounds mask: an input pixel outside the image reads as
// 0 and the activation comes after the conv; stride 2 has the extra pad at
// the bottom/right (the wrapper passes the top/left pads).  Ragged pixel,
// c_in, c_mid and c_out edges are masked here; the wrapper pads nothing.
//
// Bound.  At V2-S widths the dense conv makes the kernel bound by
// operations (9 C_in C_mid FMAs per output pixel).  fp32 FMA on CUDA cores,
// no tensor cores and no TF32 (the JAX suite's 1e-4 fp32 bar).  Each thread
// holds a register tile (2 pixels x 4 c_mid channels in the conv, PPT pixels
// x 4 c_out channels in the projection) fed by float4 shared-memory loads,
// so the inner loops issue about one load per five FMAs; the staged pixel
// stride is padded to 36 floats so a warp's float4 loads of neighbouring
// pixels fall in different banks.  wgmma, TMA and cp.async pipelining are
// later work.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int CT = 32;                  // c_in and c_mid chunk
constexpr int NTHREADS = 256;
constexpr int MAXP = 64;                // output pixels per CTA tile
constexpr int XS = CT + 4;              // floats per staged pixel (padded)
constexpr int NCG = CT / 4;             // conv: 4-channel groups of a chunk
constexpr int NPG = NTHREADS / NCG;     // conv: pixel groups (2 pixels each)
static_assert(NPG * 2 == MAXP, "each conv thread owns 2 pixels");

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

// acc[0..3] += a * w.{x,y,z,w}
__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& w) {
  acc[0] = fmaf(a, w.x, acc[0]);
  acc[1] = fmaf(a, w.y, acc[1]);
  acc[2] = fmaf(a, w.z, acc[2]);
  acc[3] = fmaf(a, w.w, acc[3]);
}

// the c_out tile of one CTA: the smallest of 32, 64, 128 covering C_out
int co_tile(int C_out) { return C_out <= 32 ? 32 : C_out <= 64 ? 64 : 128; }

size_t smem_floats(int K, int in_rows, int in_cols, int COT) {
  return (size_t)(in_rows * in_cols + MAXP) * XS + (size_t)K * K * CT * CT + (size_t)CT * COT;
}

// grid (n_tiles, ceil(C_out / COT), B), NTHREADS threads.
template <int K, int S, int COT>
__global__ void __launch_bounds__(NTHREADS, 2)
fusedmb_kernel(const float* __restrict__ x, const float* __restrict__ w_conv,
               const float* __restrict__ w_proj, float* __restrict__ out, Geom g,
               int act) {
  constexpr int OCG = COT / 4;          // projection: 4-channel groups
  constexpr int OPG = NTHREADS / OCG;   // projection: pixel groups
  constexpr int PPT = MAXP / OPG;       // projection: pixels per thread

  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);       // in_rows*in_cols x XS
  float* e_s = x_s + g.in_rows * g.in_cols * XS;      // MAXP x XS
  float* wc_s = e_s + MAXP * XS;                      // (K*K*CT) x CT
  float* wp_s = wc_s + K * K * CT * CT;               // CT x COT

  const int tile = blockIdx.x, co0 = blockIdx.y * COT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x;
  const int P = g.tile_h * g.tile_w;
  const int Q = g.in_rows * g.in_cols;

  // conv role: channels 4 * cg .. + 3 of the c_mid chunk, pixels pg, pg + NPG
  const int cg = t % NCG, pg = t / NCG;
  int xoff[2];                          // window pixel of each pixel's (0, 0) tap
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int p = pg + NPG * j;
    xoff[j] = p < P ? (p / g.tile_w) * S * g.in_cols + (p % g.tile_w) * S : 0;
  }
  // projection role: channels co0 + 4 * og .. + 3, pixels opg + OPG * j
  const int og = t % OCG, opg = t / OCG;
  float acc[PPT][4];
#pragma unroll
  for (int j = 0; j < PPT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[j][u] = 0.f;

  const float4* x4 = reinterpret_cast<const float4*>(x_s);
  const float4* w4 = reinterpret_cast<const float4*>(wc_s);
  for (int cm0 = 0; cm0 < g.C_mid; cm0 += CT) {
    float c[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ci0 = 0; ci0 < g.C_in; ci0 += CT) {
      const int nci = min(CT, g.C_in - ci0);
      __syncthreads();                  // the last chunk's readers are done
      // the halo'd input window, channels [ci0, ci0 + CT), 0 off the image
      for (int i = t; i < Q * CT; i += NTHREADS) {
        const int q = i / CT, ci = i % CT;
        const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
        float v = 0.f;
        if (ci < nci && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W)
          v = __ldg(x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + ci);
        x_s[q * XS + ci] = v;
      }
      // w_conv[:, :, ci0:ci0+CT, cm0:cm0+CT] as rows (tap, ci) of CT c_mid
      for (int i = t; i < K * K * CT * CT; i += NTHREADS) {
        const int m = i % CT, r = i / CT;
        const int ci = r % CT, tap = r / CT;
        float v = 0.f;
        if (ci < nci && cm0 + m < g.C_mid)
          v = __ldg(w_conv + ((size_t)tap * g.C_in + ci0 + ci) * g.C_mid + cm0 + m);
        wc_s[i] = v;
      }
      __syncthreads();
      const int nc4 = (nci + 3) / 4;
#pragma unroll 1
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4* xa = x4 + (xoff[0] + kh * g.in_cols + kw) * (XS / 4);
          const float4* xb = x4 + (xoff[1] + kh * g.in_cols + kw) * (XS / 4);
          const float4* wt = w4 + (kh * K + kw) * CT * NCG + cg;
#pragma unroll 4
          for (int c4 = 0; c4 < nc4; ++c4) {
            const float4 va = xa[c4], vb = xb[c4];
            const float4 w0 = wt[(4 * c4) * NCG], w1 = wt[(4 * c4 + 1) * NCG];
            const float4 w2 = wt[(4 * c4 + 2) * NCG], w3 = wt[(4 * c4 + 3) * NCG];
            fma4(c[0], va.x, w0); fma4(c[1], vb.x, w0);
            fma4(c[0], va.y, w1); fma4(c[1], vb.y, w1);
            fma4(c[0], va.z, w2); fma4(c[1], vb.z, w2);
            fma4(c[0], va.w, w3); fma4(c[1], vb.w, w3);
          }
        }
      }
    }
    // act; channels past C_mid are 0 (act(0) need not be)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float4 v;
      const int cm = cm0 + 4 * cg;
      v.x = cm < g.C_mid ? act_apply(c[j][0], act) : 0.f;
      v.y = cm + 1 < g.C_mid ? act_apply(c[j][1], act) : 0.f;
      v.z = cm + 2 < g.C_mid ? act_apply(c[j][2], act) : 0.f;
      v.w = cm + 3 < g.C_mid ? act_apply(c[j][3], act) : 0.f;
      reinterpret_cast<float4*>(e_s + (pg + NPG * j) * XS)[cg] = v;
    }
    // w_proj[cm0:cm0+CT, co0:co0+COT]
    for (int i = t; i < CT * COT; i += NTHREADS) {
      const int m = i / COT, o = i % COT;
      float v = 0.f;
      if (cm0 + m < g.C_mid && co0 + o < g.C_out)
        v = __ldg(w_proj + (size_t)(cm0 + m) * g.C_out + co0 + o);
      wp_s[i] = v;
    }
    __syncthreads();
    const float4* e4 = reinterpret_cast<const float4*>(e_s);
    const float4* p4 = reinterpret_cast<const float4*>(wp_s) + og;
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
      if (co < g.C_out) o[co] = acc[j][u];
    }
  }
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

template <int K, int S, int COT>
cudaError_t launch(const float* x, const float* w_conv, const float* w_proj,
                   float* out, const Geom& g, int act, cudaStream_t stream) {
  const size_t smem = smem_floats(K, g.in_rows, g.in_cols, COT) * sizeof(float);
  // once per instance (a function-local static), so no attribute call lands
  // inside a CUDA graph capture
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      fusedmb_kernel<K, S, COT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  const dim3 grid(n_tiles, (g.C_out + COT - 1) / COT, g.B);
  fusedmb_kernel<K, S, COT><<<grid, NTHREADS, smem, stream>>>(x, w_conv, w_proj, out,
                                                               g, act);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_co(const float* x, const float* w_conv, const float* w_proj,
                      float* out, const Geom& g, int act, cudaStream_t stream) {
  switch (co_tile(g.C_out)) {
    case 32: return launch<K, S, 32>(x, w_conv, w_proj, out, g, act, stream);
    case 64: return launch<K, S, 64>(x, w_conv, w_proj, out, g, act, stream);
    default: return launch<K, S, 128>(x, w_conv, w_proj, out, g, act, stream);
  }
}

}  // namespace

// The C interface, bound with ctypes.  fusedmb launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int fusedmb_channel_tile() { return CT; }
int fusedmb_max_tile_pixels() { return MAXP; }
int fusedmb_pixel_stride() { return XS; }
// the dynamic shared memory one launch asks for (the schedule solver's
// budget check must agree with it)
size_t fusedmb_smem_bytes(int K, int in_rows, int in_cols, int C_out) {
  return smem_floats(K, in_rows, in_cols, co_tile(C_out)) * sizeof(float);
}
const char* fusedmb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fusedmb(const float* x, const float* w_conv, const float* w_proj, float* out,
            int B, int H, int W, int C_in, int C_mid, int C_out, int K, int S,
            int out_h, int out_w, int pad_top, int pad_left, int tile_h, int tile_w,
            int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_mid = C_mid; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w;
  if (B <= 0 || B > 65535 || C_in <= 0 || C_mid <= 0 || C_out <= 0 || out_h <= 0 ||
      out_w <= 0 || tile_h <= 0 || tile_w <= 0 || tile_h * tile_w > MAXP)
    return (int)cudaErrorInvalidValue;
  g.n_tw = (out_w + tile_w - 1) / tile_w;
  g.in_rows = (tile_h - 1) * S + K;
  g.in_cols = (tile_w - 1) * S + K;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K * 10 + S) {
    case 31: return (int)launch_co<3, 1>(x, w_conv, w_proj, out, g, act, st);
    case 32: return (int)launch_co<3, 2>(x, w_conv, w_proj, out, g, act, st);
    case 51: return (int)launch_co<5, 1>(x, w_conv, w_proj, out, g, act, st);
    case 52: return (int)launch_co<5, 2>(x, w_conv, w_proj, out, g, act, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
