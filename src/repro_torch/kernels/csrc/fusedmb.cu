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
// one c_out tile of NC channels.  NC is also the c_mid chunk: the wrapper
// picks it from {24, 32, 48, 64} so that it divides C_mid and covers C_out
// where it can (core.autotune.fusedmb_chunk), so at EfficientNet-V2-S's
// widths no FMA is spent on padding.  Both products are one register-tiled
// GEMM step: a thread owns TP = 4 pixels x TC channels (TC = NC / LC, the
// warp laid out as LP pixel lanes x LC channel lanes), reads each operand
// as float4 from shared memory (a warp's LP distinct pixels and LC
// distinct channel groups, the rest broadcast) and does 4 * TP * TC FMAs
// per TP + TC loads.
//
// The halo'd input window is staged once per CTA across all of C_in (a
// chunked c_in fallback restages it per chunk where a whole window does
// not fit).  The weights stream through a two-slot cp.async ring, one step
// per (c_mid chunk, c_in chunk, tap) slice of w_conv (c_in rows x NC) and
// one per c_mid chunk for the (NC x NC) w_proj slice: the next step loads
// while this one computes, with one barrier per step.  After a chunk's last
// conv step each thread applies the activation to its sums in registers;
// the projection step reads them across the warp by shuffles (the LC lanes
// of a pixel lane hold all NC channels of its pixels), so the activated
// chunk never touches shared memory, and multiplies them into register
// accumulators kept for the whole CTA.  The output is written once at the
// end.
//
// SAME padding is a bounds mask (cp.async zero-fills an input pixel outside
// the image, and the activation comes after the conv); stride 2 has the
// extra pad at the bottom/right (the wrapper passes the top/left pads).
// Ragged pixel, c_in, c_mid and c_out edges are masked here; the wrapper
// pads nothing.
//
// Bound.  At V2-S widths the dense conv makes the kernel bound by
// operations (k^2 C_in C_mid FMAs per output pixel).  fp32 FMA on CUDA
// cores, no tensor cores and no TF32 (the JAX suite's 1e-4 fp32 bar).

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int MAXP = 128;               // output pixels per CTA tile
constexpr int TP = 4;                   // pixels per thread
constexpr int SLOTS = 2;                // cp.async ring slots over the weights

// channel lanes of a warp at chunk NC: each thread owns NC / LC channels,
// as float4 groups 4 * LC apart
__host__ __device__ constexpr int chunk_lanes(int NC) {
  return NC == 24 ? 2 : NC == 32 ? 4 : NC == 48 ? 4 : NC == 64 ? 8 : 0;
}
__host__ __device__ constexpr int pixels_per_warp(int NC) { return TP * 32 / chunk_lanes(NC); }
__host__ __device__ constexpr int max_threads(int NC) { return MAXP / pixels_per_warp(NC) * 32; }
// resident CTAs per SM the register budget is set for
__host__ __device__ constexpr int min_ctas(int NC) { return NC == 64 ? 2 : NC == 24 ? 6 : 3; }

enum Act {
  ACT_NONE = 0, ACT_RELU = 1, ACT_RELU6 = 2, ACT_SILU = 3, ACT_SIGMOID = 4,
  ACT_HARD_SWISH = 5, ACT_HARD_SIGMOID = 6
};

__device__ __forceinline__ float act_apply(float v, int act) {
  switch (act) {
    case ACT_RELU: return fmaxf(v, 0.f);
    case ACT_RELU6: return fminf(fmaxf(v, 0.f), 6.f);
    // fast exp and divide: a few ulp, far inside the 1e-4 fp32 bar (past
    // exp's range the divide by inf gives 0, the limit)
    case ACT_SILU: return __fdividef(v, 1.f + __expf(-v));
    case ACT_SIGMOID: return __fdividef(1.f, 1.f + __expf(-v));
    case ACT_HARD_SWISH: return v * fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
    case ACT_HARD_SIGMOID: return fminf(fmaxf(v + 3.f, 0.f), 6.f) * (1.f / 6.f);
    default: return v;
  }
}

struct Geom {
  int B, H, W, C_in, C_mid, C_out;
  int out_h, out_w, pad_top, pad_left;
  int tile_h, tile_w, n_tw, in_rows, in_cols;
  int ci_chunk;                         // c_in channels per staged window
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__host__ __device__ constexpr int ceil4(int n) { return (n + 3) / 4 * 4; }

// floats per staged window pixel: the chunk rounded up to 4, padded so the
// stride in float4s is odd and a warp's float4 loads of neighbouring pixels
// fall in different banks
__host__ __device__ constexpr int window_stride(int ci_chunk) {
  return ceil4(ci_chunk) + ((ceil4(ci_chunk) / 4) % 2 ? 8 : 4);
}

// shared memory: the window and SLOTS ring slots of max(c_in rows, NC
// rows) x NC weights
size_t smem_floats(int in_rows, int in_cols, int ci_chunk, int NC) {
  const int rows = ceil4(ci_chunk) > NC ? ceil4(ci_chunk) : NC;
  return (size_t)in_rows * in_cols * window_stride(ci_chunk) + (size_t)SLOTS * rows * NC;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[j][c] += sum_k a[j][k] * b[k][c] over n4 * 4 rows k: a row j at
// a_s + aoff[j] (k contiguous), b row k at b_s + k * NC, this thread's
// channels 4 * lc + 4 * LC * u + (0..3)
template <int NC, int TC = NC / chunk_lanes(NC)>
__device__ __forceinline__ void gemm_step(float (&acc)[TP][TC],
                                          const float* __restrict__ a_s,
                                          const int (&aoff)[TP],
                                          const float* __restrict__ b_s, int lc, int n4) {
  constexpr int LC = chunk_lanes(NC);
  const float* b0 = b_s + 4 * lc;
#pragma unroll 4
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

// acc[j][c] += sum_m e[j][m] * b[m][c] over the chunk's NC channels m,
// where e[j][m] is held by lane (lp, (m / 4) % LC) of this warp as its
// e[j][4 * (m / (4 * LC)) + m % 4]; b row m at b_s + m * NC
template <int NC, int TC = NC / chunk_lanes(NC)>
__device__ __forceinline__ void project_step(float (&acc)[TP][TC], const float (&e)[TP][TC],
                                             const float* __restrict__ b_s, int lp, int lc) {
  constexpr int LC = chunk_lanes(NC);
  const float* b0 = b_s + 4 * lc;
#pragma unroll
  for (int uo = 0; uo < TC / 4; ++uo) {
#pragma unroll 1
    for (int lo = 0; lo < LC; ++lo) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = 4 * lo + 4 * LC * uo + v;
        float ev[TP];
#pragma unroll
        for (int j = 0; j < TP; ++j) ev[j] = __shfl_sync(0xffffffffu, e[j][4 * uo + v], lp * LC + lo);
        const float* brow = b0 + m * NC;
#pragma unroll
        for (int u = 0; u < TC / 4; ++u) {
          const float4 b = *reinterpret_cast<const float4*>(brow + 4 * LC * u);
#pragma unroll
          for (int j = 0; j < TP; ++j) {
            acc[j][4 * u] = fmaf(ev[j], b.x, acc[j][4 * u]);
            acc[j][4 * u + 1] = fmaf(ev[j], b.y, acc[j][4 * u + 1]);
            acc[j][4 * u + 2] = fmaf(ev[j], b.z, acc[j][4 * u + 2]);
            acc[j][4 * u + 3] = fmaf(ev[j], b.w, acc[j][4 * u + 3]);
          }
        }
      }
    }
  }
}

// grid (n_tiles, ceil(C_out / NC), B); 32 * ceil(pixels / pixels_per_warp)
// threads, each owning TP pixels x NC / LC channels of both products.
template <int K, int S, int NC>
__global__ void __launch_bounds__(max_threads(NC), min_ctas(NC))
fusedmb_kernel(const float* __restrict__ x, const float* __restrict__ w_conv,
               const float* __restrict__ w_proj, float* __restrict__ out, Geom g,
               int act) {
  constexpr int LC = chunk_lanes(NC), TC = NC / LC, LP = 32 / LC;
  constexpr int PPW = TP * LP;
  constexpr int KK = K * K;

  const int P = g.tile_h * g.tile_w, Q = g.in_rows * g.in_cols;
  const int XS = window_stride(g.ci_chunk);
  const int rows = ceil4(g.ci_chunk) > NC ? ceil4(g.ci_chunk) : NC;
  extern __shared__ float4 smem4[];
  float* x_s = reinterpret_cast<float*>(smem4);       // Q x XS
  float* w_s = x_s + Q * XS;                          // SLOTS x rows x NC

  const int tile = blockIdx.x, co0 = blockIdx.y * NC, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x, nt = blockDim.x;
  const int lane = t % 32, lp = lane / LC, lc = lane % LC;

  // At stride 2 the window's even columns are stored before its odd ones,
  // so a warp's neighbouring output pixels read neighbouring window pixels
  // (distinct banks) at every tap: window column col sits at wcol(col).
  const int half = (g.in_cols + 1) / 2;
  auto wcol = [&](int col) { return S == 2 ? (col & 1) * half + (col >> 1) : col; };
  // this thread's pixels (a pixel past the tile reads pixel P - 1 and is
  // never written): offsets of their (0, 0) taps in the window
  int xoff[TP];
#pragma unroll
  for (int j = 0; j < TP; ++j) {
    const int p = min((t / 32) * PPW + lp + LP * j, P - 1);
    xoff[j] = ((p / g.tile_w) * S * g.in_cols + wcol((p % g.tile_w) * S)) * XS;
  }

  const int n_ci = (g.C_in + g.ci_chunk - 1) / g.ci_chunk;
  const int per_chunk = n_ci * KK + 1;  // conv steps, then the projection
  const int n_steps = (g.C_mid + NC - 1) / NC * per_chunk;
  const bool vec_x = g.C_in % 4 == 0, vec_m = g.C_mid % 4 == 0, vec_o = g.C_out % 4 == 0;

  // the halo'd window, channels [i * ci_chunk, + ci_chunk), 0 off the image
  auto stage_window = [&](int i) {
    const int ci0 = i * g.ci_chunk, nci = min(g.ci_chunk, g.C_in - ci0);
    const int n4 = (nci + 3) / 4;
    for (int e = t; e < Q * n4; e += nt) {
      const int q = e / n4, c = 4 * (e % n4);
      const int r = q / g.in_cols, col = q % g.in_cols;
      const int ih = ih0 + r, iw = iw0 + col;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const float* src = x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + c;
      float* dst = x_s + (r * g.in_cols + wcol(col)) * XS + c;
      if (vec_x) {
        cp_async16(dst, in ? src : x, in ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = in && c + u < nci;
          cp_async4(dst + u, ok ? src + u : x, ok ? 4 : 0);
        }
      }
    }
  };
  // NC-wide rows [r0, r0 + n_rows) (r < r_end valid) of a row-major matrix
  // with ld columns, columns [col0, col0 + NC) (col < ld valid)
  auto stage_rows = [&](float* dst, const float* m, int ld, int r0, int n_rows, int r_end,
                        int col0, bool vec) {
    for (int e = t; e < n_rows * (NC / 4); e += nt) {
      const int r = e / (NC / 4), c = 4 * (e % (NC / 4));
      const int row = r0 + r, col = col0 + c;
      const float* src = m + (size_t)row * ld + col;
      if (vec) {
        const bool ok = row < r_end && col < ld;
        cp_async16(dst + r * NC + c, ok ? src : m, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = row < r_end && col + u < ld;
          cp_async4(dst + r * NC + c + u, ok ? src + u : m, ok ? 4 : 0);
        }
      }
    }
  };
  // ring step s: w_conv[tap, c_in chunk, c_mid chunk] or w_proj[c_mid chunk, c_out tile]
  auto stage_step = [&](int s) {
    float* dst = w_s + (s % SLOTS) * rows * NC;
    const int c = s / per_chunk, r = s % per_chunk;
    if (r < n_ci * KK) {
      const int ci0 = (r / KK) * g.ci_chunk, tap = r % KK;
      const int nci = min(g.ci_chunk, g.C_in - ci0);
      // rows of this tap: (tap * C_in + ci0 + ci) of the (k*k*C_in, C_mid) matrix
      stage_rows(dst, w_conv, g.C_mid, tap * g.C_in + ci0, ceil4(nci),
                 tap * g.C_in + ci0 + nci, c * NC, vec_m);
    } else {
      stage_rows(dst, w_proj, g.C_out, c * NC, NC, g.C_mid, co0, vec_o);
    }
  };

  float acc[TP][TC], oacc[TP][TC];
#pragma unroll
  for (int j = 0; j < TP; ++j)
#pragma unroll
    for (int u = 0; u < TC; ++u) oacc[j][u] = 0.f;

  stage_window(0);
  stage_step(0);
  cp_async_commit();
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait_all();
    __syncthreads();                    // step s landed; step s - 1 is read
    const int c = s / per_chunk, r = s % per_chunk;
    const bool conv = r < n_ci * KK;
    if (conv && r % KK == 0 && n_ci > 1 && s > 0) {
      stage_window(r / KK);             // chunked fallback: restage
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    if (s + 1 < n_steps) stage_step(s + 1);
    cp_async_commit();
    const float* w_slot = w_s + (s % SLOTS) * rows * NC;
    if (conv) {
      const int tap = r % KK, i = r / KK;
      if (r == 0) {
#pragma unroll
        for (int j = 0; j < TP; ++j)
#pragma unroll
          for (int u = 0; u < TC; ++u) acc[j][u] = 0.f;
      }
      const int nci = min(g.ci_chunk, g.C_in - i * g.ci_chunk);
      // the tap's offset from a pixel's (0, 0) tap: wcol(S * pc + kw) is
      // wcol(S * pc) + wcol(kw) at both strides
      gemm_step<NC>(acc, x_s + ((tap / K) * g.in_cols + wcol(tap % K)) * XS, xoff, w_slot,
                    lc, (nci + 3) / 4);
      if (r == n_ci * KK - 1) {
        // act; channels past C_mid are 0 (act(0) need not be)
#pragma unroll
        for (int u = 0; u < TC; ++u) {
          const bool in = c * NC + 4 * lc + 4 * LC * (u / 4) + u % 4 < g.C_mid;
#pragma unroll
          for (int j = 0; j < TP; ++j) acc[j][u] = in ? act_apply(acc[j][u], act) : 0.f;
        }
      }
    } else {
      project_step<NC>(oacc, acc, w_slot, lp, lc);
    }
  }

#pragma unroll
  for (int j = 0; j < TP; ++j) {
    const int p = (t / 32) * PPW + lp + LP * j;
    if (p >= P) continue;
    const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
    if (oh >= g.out_h || ow >= g.out_w) continue;
    float* o = out + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out;
#pragma unroll
    for (int u = 0; u < TC / 4; ++u) {
      const int co = co0 + 4 * lc + 4 * LC * u;
      if (vec_o && co < g.C_out) {
        *reinterpret_cast<float4*>(o + co) =
            make_float4(oacc[j][4 * u], oacc[j][4 * u + 1], oacc[j][4 * u + 2],
                        oacc[j][4 * u + 3]);
      } else if (!vec_o) {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (co + v < g.C_out) o[co + v] = oacc[j][4 * u + v];
      }
    }
  }
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

template <int K, int S, int NC>
cudaError_t launch(const float* x, const float* w_conv, const float* w_proj,
                   float* out, const Geom& g, int act, cudaStream_t stream) {
  const int pixels = g.tile_h * g.tile_w;
  const size_t smem = smem_floats(g.in_rows, g.in_cols, g.ci_chunk, NC) * sizeof(float);
  // once per instance (a function-local static), so no attribute call lands
  // inside a CUDA graph capture
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      fusedmb_kernel<K, S, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  const int threads = (pixels + pixels_per_warp(NC) - 1) / pixels_per_warp(NC) * 32;
  const dim3 grid(n_tiles, (g.C_out + NC - 1) / NC, g.B);
  fusedmb_kernel<K, S, NC><<<grid, threads, smem, stream>>>(x, w_conv, w_proj, out, g,
                                                             act);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_nc(const float* x, const float* w_conv, const float* w_proj,
                      float* out, const Geom& g, int nc, int act, cudaStream_t stream) {
  switch (nc) {
    case 24: return launch<K, S, 24>(x, w_conv, w_proj, out, g, act, stream);
    case 32: return launch<K, S, 32>(x, w_conv, w_proj, out, g, act, stream);
    case 48: return launch<K, S, 48>(x, w_conv, w_proj, out, g, act, stream);
    case 64: return launch<K, S, 64>(x, w_conv, w_proj, out, g, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface, bound with ctypes.  fusedmb launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int fusedmb_max_tile_pixels() { return MAXP; }
int fusedmb_pixels_per_thread() { return TP; }
int fusedmb_ring_slots() { return SLOTS; }
int fusedmb_chunk_lanes(int nc) { return chunk_lanes(nc); }
// the dynamic shared memory one launch asks for (the schedule solver's
// budget check must agree with it)
size_t fusedmb_smem_bytes(int in_rows, int in_cols, int ci_chunk, int nc) {
  return smem_floats(in_rows, in_cols, ci_chunk, nc) * sizeof(float);
}
const char* fusedmb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fusedmb(const float* x, const float* w_conv, const float* w_proj, float* out,
            int B, int H, int W, int C_in, int C_mid, int C_out, int K, int S,
            int out_h, int out_w, int pad_top, int pad_left, int tile_h, int tile_w,
            int nc, int ci_chunk, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_mid = C_mid; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w; g.ci_chunk = ci_chunk;
  // a chunk smaller than C_in is a multiple of 4, so every window chunk
  // but the last is whole float4s
  if (B <= 0 || B > 65535 || C_in <= 0 || C_mid <= 0 || C_out <= 0 || out_h <= 0 ||
      out_w <= 0 || tile_h <= 0 || tile_w <= 0 || tile_h * tile_w > MAXP ||
      ci_chunk <= 0 || (ci_chunk < C_in && ci_chunk % 4))
    return (int)cudaErrorInvalidValue;
  g.n_tw = (out_w + tile_w - 1) / tile_w;
  g.in_rows = (tile_h - 1) * S + K;
  g.in_cols = (tile_w - 1) * S + K;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K * 10 + S) {
    case 31: return (int)launch_nc<3, 1>(x, w_conv, w_proj, out, g, nc, act, st);
    case 32: return (int)launch_nc<3, 2>(x, w_conv, w_proj, out, g, nc, act, st);
    case 51: return (int)launch_nc<5, 1>(x, w_conv, w_proj, out, g, nc, act, st);
    case 52: return (int)launch_nc<5, 2>(x, w_conv, w_proj, out, g, nc, act, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
