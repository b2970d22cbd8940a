// Single-pass Fused-MBConv kernel for Hopper (sm_90a): fp32 on CUDA cores,
// the bf16 build on bf16 tensor cores.
//
// Replaces the Pallas TPU kernel of the JAX package's Fused-MBConv path
// (src/repro/kernels/convdk_fusedmb.py):
//
//   fusedmb_kernel  <- _fusedmb_kernel (:59), launched by fusedmb_pallas (:133)
//
// What it computes (NHWC activations, w_conv (k, k, C_in, C_mid) HWIO,
// w_proj (C_mid, C_out), all in one storage type T), EfficientNet-V2's
// fused stages without the residual (the model layer adds it):
//
//   dense k x k / s conv (reduce C_in) -> act -> projection 1x1 (reduce C_mid)
//
// The expanded (C_mid) tensor never reaches device memory.
//
// Design on this card (the fp32 build; the bf16 build's below).  The Pallas grid (b, c_out-blk, strip, c_mid-blk,
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
// operations (k^2 C_in C_mid products per output pixel).  The fp32 build
// runs fp32 FMAs on CUDA cores, no tensor cores and no TF32 (the JAX
// suite's 1e-4 fp32 bar); the bf16 build runs bf16 tensor cores.
//
// Storage type.  The kernel is a template over T, float or __nv_bfloat16
// (the JAX kernel's x.dtype); each build of this file instantiates one for
// the C interface (__nv_bfloat16 with -DBF16_STORAGE).  Whatever T, every
// product is exact or fp32 and every sum fp32, as the Pallas kernel casts
// the window and both weights to fp32 and rounds o_ref once: the output
// rounds once to T.  The fp32 build is the design above.
//
// The bf16 build (fusedmb_mma) runs both products on tensor cores
// (mma.sync m16n8k16, fp32 sums, operands by ldmatrix; mma.cuh):
//
//   conv        an implicit GEMM: M the tile's output pixels, in m16 row
//               groups; N the c_mid chunk CM (32 or 64); K runs over (tap,
//               c_in) in 8-channel groups flattened across the taps, the
//               row order of w_conv's (k*k*C_in, C_mid) view, so C_in 24
//               fills a k16 step with no padding but the tail's.  A warp
//               owns 64 / CM row groups across the chunk (32 fp32 sums a
//               thread either way; at CM 32 each B fragment read from
//               shared memory serves two groups).  ldmatrix takes one row
//               address a lane, so each 8-channel half of an A fragment
//               comes from its own pixel and tap of the staged window.  A
//               bf16 x bf16 product is exact in fp32: one mma per k16 step
//               and n8 tile is the Pallas kernel's function.
//   projection  the activated chunk stays in the conv's accumulators: two
//               neighbouring n8 accumulator tiles are one k16 A fragment of
//               the projection.  An activated value is fp32, not a bf16
//               one, so it is split exactly into three bf16 terms
//               (bf16x3_split2) and three mmas on the same w_proj fragment
//               add hi w + mid w + lo w, each product exact in fp32: the
//               operand is never rounded to one bf16.
//
// A CTA owns all of C_out up to 64 channels (the c_out tile NC, one of 24,
// 32, 48, 64; wider outputs take several tiles, each repeating the conv),
// so at EfficientNet-V2-S's widths the conv runs once per pixel.  The
// wrapper takes CM 64 where C_mid's 64-channel chunks pad no more than its
// 32-channel ones (core.autotune.fusedmb_mid_chunk): each A fragment then
// serves twice the channels, and the CTA's warps are twice as many.  The
// window pixel stride is an odd multiple of 16 bytes (window_stride16), so
// a matrix's 8 rows of neighbouring pixels fall in 8 bank groups; channels
// past C_in are zero-filled, and w_conv rows past a tap's channels and the
// k16 tail are zero, the tail's A rows read a zero row.  The weights
// stream through a SLOTS16-slot cp.async ring, K16_SLOT k16 steps of
// w_conv rows (c_mid chunk wide) or one c_mid chunk of w_proj rows (c_out
// tile wide) a slot, rows padded by 8 bf16 to an odd multiple of 16 bytes,
// B fragments by ldmatrix.trans.  C_mid 24 pads to 32 (zero weights; the
// padded channels are set to 0 after the activation).  HMMA's fp32
// additions round in another order than FMAs, so the bf16 build is held to
// 1 bf16 ulp of the plain fp32 sum (chip_smoke.py's _bf16_verdict); it
// repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "mma.cuh"
#include "storage.cuh"

namespace {

constexpr int MAXP = 128;               // output pixels per CTA tile
constexpr int TP = 4;                   // pixels per thread
constexpr int SLOTS = 2;                // cp.async ring slots over the weights

// the bf16 build's tensor-core design (fusedmb_mma), at c_mid chunk CM
// (32 or 64): a warp owns 64 / CM m16 row groups (32 conv sums a thread
// either way)
constexpr int SLOTS16 = 2;              // cp.async ring slots over the weights
constexpr int K16_SLOT = 16;            // k16 steps of w_conv per ring slot
__host__ __device__ constexpr int groups16(int CM) { return 64 / CM; }

// channel lanes of a warp at chunk NC: each thread owns NC / LC channels,
// as float4 groups 4 * LC apart
__host__ __device__ constexpr int chunk_lanes(int NC) {
  return NC == 24 ? 2 : NC == 32 ? 4 : NC == 48 ? 4 : NC == 64 ? 8 : 0;
}
__host__ __device__ constexpr int pixels_per_warp(int NC, int eb, int CM) {
  return eb == 2 ? groups16(CM) * MMA_M : TP * 32 / chunk_lanes(NC);
}
__host__ __device__ constexpr int max_threads(int NC, int eb, int CM) {
  return MAXP / pixels_per_warp(NC, eb, CM) * 32;
}
// resident CTAs per SM the register budget is set for
__host__ __device__ constexpr int min_ctas(int NC, int eb, int CM) {
  return eb == 2 ? (CM == 64 ? 2 : 3) : NC == 64 ? 2 : NC == 24 ? 6 : 3;
}

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__host__ __device__ constexpr int ceil4(int n) { return (n + 3) / 4 * 4; }
__host__ __device__ constexpr int ceil8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int ceil16(int n) { return (n + 15) / 16 * 16; }

// elements per staged window pixel: the chunk rounded up to 4, padded so
// the stride in 4-channel groups is odd and a warp's loads of neighbouring
// pixels fall in different banks
__host__ __device__ constexpr int window_stride(int ci_chunk) {
  return ceil4(ci_chunk) + ((ceil4(ci_chunk) / 4) % 2 ? 8 : 4);
}

// bf16 elements per staged window pixel of the tensor-core build: the
// chunk rounded up to 8 (one 16-byte ldmatrix row a channel group), padded
// to an odd multiple of 16 bytes (24 channels: 48 bytes; 48: 56; 64: 72)
__host__ __device__ constexpr int window_stride16(int ci_chunk) {
  return ceil8(ci_chunk) + ((ceil8(ci_chunk) / 8) % 2 ? 0 : 8);
}

// bf16 elements of one ring slot of the tensor-core build: K16_SLOT k16
// steps of w_conv rows (CM + 8 each) or CM w_proj rows of the c_out tile
// rounded up to 16, + 8
__host__ __device__ constexpr int ring_slot16(int NC, int CM) {
  return K16_SLOT * 16 * (CM + 8) > CM * (ceil16(NC) + 8) ? K16_SLOT * 16 * (CM + 8)
                                                            : CM * (ceil16(NC) + 8);
}

// shared memory: fp32 design, the window and SLOTS ring slots of
// max(c_in rows, NC rows) x NC weights, eb bytes an element; bf16
// tensor-core design at c_mid chunk CM, SLOTS16 ring slots, the window at
// window_stride16 and one zero row of 8 channels
size_t smem_bytes(int in_rows, int in_cols, int ci_chunk, int NC, int CM, int eb) {
  if (eb == 2)
    return ((size_t)SLOTS16 * ring_slot16(NC, CM) +
            (size_t)in_rows * in_cols * window_stride16(ci_chunk) + 8) * eb;
  const int rows = ceil4(ci_chunk) > NC ? ceil4(ci_chunk) : NC;
  return ((size_t)in_rows * in_cols * window_stride(ci_chunk) + (size_t)SLOTS * rows * NC) *
         eb;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[j][c] += sum_k a[j][k] * b[k][c] over n4 * 4 rows k: a row j at
// a_s + aoff[j] (k contiguous), b row k at b_s + k * NC, this thread's
// channels 4 * lc + 4 * LC * u + (0..3)
template <int NC, typename T, int TC = NC / chunk_lanes(NC)>
__device__ __forceinline__ void gemm_step(float (&acc)[TP][TC], const T* __restrict__ a_s,
                                          const int (&aoff)[TP],
                                          const T* __restrict__ b_s, int lc, int n4) {
  constexpr int LC = chunk_lanes(NC);
  const T* b0 = b_s + 4 * lc;
#pragma unroll 4
  for (int c4 = 0; c4 < n4; ++c4) {
    float4 a[TP];
#pragma unroll
    for (int j = 0; j < TP; ++j) a[j] = ld4(a_s + aoff[j] + 4 * c4);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const T* brow = b0 + (4 * c4 + kk) * NC;
#pragma unroll
      for (int u = 0; u < TC / 4; ++u) {
        const float4 b = ld4(brow + 4 * LC * u);
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
template <int NC, typename T, int TC = NC / chunk_lanes(NC)>
__device__ __forceinline__ void project_step(float (&acc)[TP][TC], const float (&e)[TP][TC],
                                             const T* __restrict__ b_s, int lp, int lc) {
  constexpr int LC = chunk_lanes(NC);
  const T* b0 = b_s + 4 * lc;
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
        const T* brow = b0 + m * NC;
#pragma unroll
        for (int u = 0; u < TC / 4; ++u) {
          const float4 b = ld4(brow + 4 * LC * u);
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

// 8 bf16 elements from src to dst (16-byte aligned), the first n of them
// valid (0 <= n <= 8), the rest zero: one 16-byte copy where the source
// rows are 16-byte aligned (align 8: n is 0 or 8), two 8-byte copies where
// they are 8-byte aligned (align 4: n a multiple of 4), else element by
// element.  base is any valid address, read by nothing.
__device__ __forceinline__ void cp8(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                    const __nv_bfloat16* base, int n, int align) {
  if (align == 8) {
    cp_async<16>(dst, n ? src : base, n ? 16 : 0);
  } else if (align == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = min(max(n - 4 * h, 0), 4);
      cp4(dst + 4 * h, m ? src + 4 * h : base, m);
    }
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) cp1(dst + u, u < n ? src + u : base, u < n);
  }
}

__device__ __forceinline__ int copy_align(int row_len) {
  return row_len % 8 == 0 ? 8 : row_len % 4 == 0 ? 4 : 1;
}

// The bf16 build's kernel body at c_mid chunk CM: both products on tensor
// cores (the "Storage type" note above).  Warp w owns the MB = 64 / CM m16
// row groups MB w .. MB w + MB - 1 of the tile's pixels (a row past the
// tile reads pixel P - 1 and is never stored) across the c_mid chunk
// (conv sums) and the c_out tile (projection sums, kept for the whole
// CTA).  The ring walks the steps of each c_mid chunk in order: the conv's
// ring steps of each c_in chunk (K16_SLOT k16 steps each, the last one
// short), then the projection; the next SLOTS16 - 1 steps load while
// one computes, with one barrier per step.
template <int K, int S, int NC, int CM>
__device__ __forceinline__ void fusedmb_mma(const __nv_bfloat16* __restrict__ x,
                                            const __nv_bfloat16* __restrict__ w_conv,
                                            const __nv_bfloat16* __restrict__ w_proj,
                                            __nv_bfloat16* __restrict__ out, const Geom& g,
                                            int act) {
  using T = __nv_bfloat16;
  constexpr int KK = K * K;
  constexpr int MB = groups16(CM), KS = K16_SLOT;
  constexpr int NJ = CM / 8;            // n8 tiles of the c_mid chunk
  constexpr int NO = NC / 8;            // n8 tiles of the c_out tile
  constexpr int WC = CM + 8;            // elements per staged w_conv row
  constexpr int WO = ceil16(NC) + 8;    // elements per staged w_proj row
  constexpr int SLOT = ring_slot16(NC, CM);

  const int P = g.tile_h * g.tile_w, Q = g.in_rows * g.in_cols;
  const int XS = window_stride16(g.ci_chunk);
  extern __shared__ float4 smem4[];
  T* w_s = reinterpret_cast<T*>(smem4);               // SLOTS16 x SLOT
  T* x_s = w_s + SLOTS16 * SLOT;                      // Q x XS
  T* zero_s = x_s + Q * XS;                           // 8 zeros

  const int tile = blockIdx.x, co0 = blockIdx.y * NC, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x, nt = blockDim.x, lane = t % 32, warp = t / 32;
  const int fr = lane / 4, fc = 2 * (lane % 4);      // fragment row, column

  // stride 2 stores the window's even columns before its odd ones, so
  // neighbouring output pixels read neighbouring window pixels at every tap
  const int half = (g.in_cols + 1) / 2;
  auto wcol = [&](int col) { return S == 2 ? (col & 1) * half + (col >> 1) : col; };
  // the (0, 0) tap of the A row this lane addresses in each of its groups
  int xoff[MB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int p = min((warp * MB + mb) * MMA_M + lane % 16, P - 1);
    xoff[mb] = ((p / g.tile_w) * S * g.in_cols + wcol((p % g.tile_w) * S)) * XS;
  }

  const int n_ci = (g.C_in + g.ci_chunk - 1) / g.ci_chunk;
  const int n_cm = (g.C_mid + CM - 1) / CM;
  const int al_x = copy_align(g.C_in), al_m = copy_align(g.C_mid),
            al_o = copy_align(g.C_out);
  // c_in chunk i: its channels, 8-channel groups a tap, k16 steps, ring steps
  auto chunk_c = [&](int i) { return min(g.ci_chunk, g.C_in - i * g.ci_chunk); };
  auto chunk_g = [&](int i) { return (chunk_c(i) + 7) / 8; };
  auto chunk_k16 = [&](int i) { return (KK * chunk_g(i) + 1) / 2; };
  auto chunk_steps = [&](int i) { return (chunk_k16(i) + KS - 1) / KS; };
  int per_cm = 1;                       // ring steps per c_mid chunk
  for (int i = 0; i < n_ci; ++i) per_cm += chunk_steps(i);
  const int n_steps = n_cm * per_cm;

  // the halo'd window of c_in chunk i, zero off the image and past C_in
  auto stage_window = [&](int i) {
    const int ci0 = i * g.ci_chunk, nci = chunk_c(i), ng = chunk_g(i);
    for (int e = t; e < Q * ng; e += nt) {
      const int q = e / ng, j = e % ng;
      const int r = q / g.in_cols, col = q % g.in_cols;
      const int ih = ih0 + r, iw = iw0 + col;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      cp8(x_s + (r * g.in_cols + wcol(col)) * XS + 8 * j,
          x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + 8 * j, x,
          in ? min(8, nci - 8 * j) : 0, al_x);
    }
  };
  // A step of the ring: (c_mid chunk c, c_in chunk i, ring step r), i ==
  // n_ci for the projection
  struct Step { int c, i, r; };
  auto advance = [&](Step& st) {
    if (st.i == n_ci) {
      st = {st.c + 1, 0, 0};
    } else if (++st.r == chunk_steps(st.i)) {
      st.r = 0;
      ++st.i;
    }
  };
  auto stage_step = [&](const Step& st, int slot) {
    T* dst = w_s + slot * SLOT;
    if (st.i < n_ci) {
      // KS k16 steps of the chunk's flattened (tap, 8-channel group)
      // rows of w_conv, c_mid columns [c * CM, + CM)
      const int ci0 = st.i * g.ci_chunk, nci = chunk_c(st.i), ng = chunk_g(st.i);
      const int k0 = st.r * KS * 16;
      const int rows = min(KS, chunk_k16(st.i) - st.r * KS) * 16;
      const int cm0 = st.c * CM;
      for (int e = t; e < rows * (CM / 8); e += nt) {
        const int kr = e / (CM / 8), j = e % (CM / 8);
        const int gi = (k0 + kr) / 8, ch = (gi % ng) * 8 + kr % 8, tap = gi / ng;
        const int col = cm0 + 8 * j;
        const bool ok = tap < KK && ch < nci;
        cp8(dst + kr * WC + 8 * j, w_conv + (size_t)(tap * g.C_in + ci0 + ch) * g.C_mid + col,
            w_conv, ok ? min(max(g.C_mid - col, 0), 8) : 0, al_m);
      }
    } else {
      // w_proj rows [c * CM, + CM), the c_out tile's columns
      for (int e = t; e < CM * (WO - 8) / 8; e += nt) {
        const int m = e / ((WO - 8) / 8), j = e % ((WO - 8) / 8);
        const int row = st.c * CM + m, col = co0 + 8 * j;
        const bool ok = row < g.C_mid && 8 * j < NC;
        cp8(dst + m * WO + 8 * j, w_proj + (size_t)row * g.C_out + col, w_proj,
            ok ? min(max(g.C_out - col, 0), 8) : 0, al_o);
      }
    }
  };

  float acc[MB][NJ][4], oacc[MB][NO][4];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int j = 0; j < NO; ++j) oacc[mb][j][0] = oacc[mb][j][1] = oacc[mb][j][2] = oacc[mb][j][3] = 0.f;

  if (t < 8) zero_s[t] = __float2bfloat16_rn(0.f);
  stage_window(0);
  Step load = {0, 0, 0}, cur = {0, 0, 0};
#pragma unroll
  for (int j = 0; j < SLOTS16 - 1; ++j) {
    if (j < n_steps) stage_step(load, j);
    advance(load);
    cp_async_commit();
  }
  // this lane's (tap row, tap column, 8-channel group) of the conv's
  // current k16 step: the group 2 k + lane / 16 of the chunk's flattened K
  int kh = 0, kw = 0, cg = 0, ng = 1;
  for (int s = 0; s < n_steps; ++s) {
    cp_async_wait<SLOTS16 - 2>();
    __syncthreads();                    // step s landed; step s - 1 is read
    const bool conv = cur.i < n_ci;
    if (conv && cur.r == 0 && n_ci > 1 && s > 0) {
      stage_window(cur.i);              // chunked fallback: restage
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
    }
    if (s + SLOTS16 - 1 < n_steps) stage_step(load, (s + SLOTS16 - 1) % SLOTS16);
    advance(load);
    cp_async_commit();
    const T* w_slot = w_s + (s % SLOTS16) * SLOT;
    if (conv) {
      if (cur.i == 0 && cur.r == 0) {
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int j = 0; j < NJ; ++j) acc[mb][j][0] = acc[mb][j][1] = acc[mb][j][2] = acc[mb][j][3] = 0.f;
      }
      if (cur.r == 0) {
        ng = chunk_g(cur.i);
        kh = 0;
        kw = ng == 1 ? lane / 16 : 0;
        cg = ng == 1 ? 0 : lane / 16;
      }
      const int nk = min(KS, chunk_k16(cur.i) - cur.r * KS);
#pragma unroll 8
      for (int kk = 0; kk < nk; ++kk) {
        // B fragments of the whole c_mid chunk, two n8 tiles per ldmatrix
        unsigned bf[NJ / 2][4];
#pragma unroll
        for (int j = 0; j < NJ / 2; ++j)
          ldsm_x4_trans(bf[j], w_slot + (16 * kk + lane % 16) * WC + 16 * j + 8 * (lane / 16));
        // this lane's row: its pixel at the tap of its group, or the zero
        // row in the k16 tail past the last tap
        const int toff = (kh * g.in_cols + wcol(kw)) * XS + 8 * cg;
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          unsigned af[4];
          ldsm_x4(af, kh < K ? x_s + xoff[mb] + toff : zero_s);
#pragma unroll
          for (int j = 0; j < NJ; ++j)
            mma_bf16(acc[mb][j], af, bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
        }
        // two groups on: at most two taps on where a tap has one group
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (++cg == ng) {
            cg = 0;
            if (++kw == K) {
              kw = 0;
              ++kh;
            }
          }
      }
      if (cur.i == n_ci - 1 && cur.r == chunk_steps(cur.i) - 1) {
        // act; channels past C_mid are 0 (act(0) need not be)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool in = cur.c * CM + 8 * j + fc + (e & 1) < g.C_mid;
#pragma unroll
            for (int mb = 0; mb < MB; ++mb)
              acc[mb][j][e] = in ? act_apply(acc[mb][j][e], act) : 0.f;
          }
      }
    } else {
      // the activated chunk from registers: accumulator tiles 2 kk and
      // 2 kk + 1 are the A fragment of k16 step kk (register r: tile
      // 2 kk + (r >> 1), pair r & 1), split into three exact bf16 terms
#pragma unroll
      for (int kk = 0; kk < CM / 16; ++kk) {
        unsigned bf[(NO + 1) / 2][4];
#pragma unroll
        for (int j = 0; j < (NO + 1) / 2; ++j)
          ldsm_x4_trans(bf[j], w_slot + (16 * kk + lane % 16) * WO + 16 * j + 8 * (lane / 16));
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          unsigned terms[3][4];         // hi, mid, lo
#pragma unroll
          for (int r = 0; r < 4; ++r)
            bf16x3_split2(acc[mb][2 * kk + (r >> 1)][2 * (r & 1)],
                          acc[mb][2 * kk + (r >> 1)][2 * (r & 1) + 1], terms[0][r], terms[1][r],
                          terms[2][r]);
          // one term over every n8 tile, then the next: the products into
          // one accumulator stand NO apart, not back to back
#pragma unroll
          for (int e = 0; e < 3; ++e)
#pragma unroll
            for (int j = 0; j < NO; ++j)
              mma_bf16(oacc[mb][j], terms[e], bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
        }
      }
    }
    advance(cur);
  }

  // rows fr and fr + 8 of each m16 group, two neighbouring channels each,
  // rounded once to bf16
  const bool pair = (g.C_out & 1) == 0;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = (warp * MB + mb) * MMA_M + fr + 8 * h;
      if (p >= P) continue;
      const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
      if (oh >= g.out_h || ow >= g.out_w) continue;
      T* o = out + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        const int co = co0 + 8 * j + fc;
        if (co >= g.C_out) continue;
        const float v0 = oacc[mb][j][2 * h], v1 = oacc[mb][j][2 * h + 1];
        if (pair) {
          *reinterpret_cast<__nv_bfloat162*>(o + co) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[co] = __float2bfloat16_rn(v0);
          if (co + 1 < g.C_out) o[co + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

// The fp32 build's kernel body (the design at the top of this file):
// 32 * ceil(pixels / pixels_per_warp) threads, each owning TP pixels x
// NC / LC channels of both products.
template <int K, int S, int NC, typename T>
__device__ __forceinline__ void fusedmb_fma(const T* __restrict__ x, const T* __restrict__ w_conv,
                                            const T* __restrict__ w_proj, T* __restrict__ out,
                                            const Geom& g, int act) {
  constexpr int LC = chunk_lanes(NC), TC = NC / LC, LP = 32 / LC;
  constexpr int PPW = TP * LP;
  constexpr int KK = K * K;

  const int P = g.tile_h * g.tile_w, Q = g.in_rows * g.in_cols;
  const int XS = window_stride(g.ci_chunk);
  const int rows = ceil4(g.ci_chunk) > NC ? ceil4(g.ci_chunk) : NC;
  extern __shared__ float4 smem4[];
  T* x_s = reinterpret_cast<T*>(smem4);               // Q x XS
  T* w_s = x_s + Q * XS;                              // SLOTS x rows x NC

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
      const T* src = x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + c;
      T* dst = x_s + (r * g.in_cols + wcol(col)) * XS + c;
      if (vec_x) {
        cp4(dst, in ? src : x, in ? 4 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = in && c + u < nci;
          cp1(dst + u, ok ? src + u : x, ok);
        }
      }
    }
  };
  // NC-wide rows [r0, r0 + n_rows) (r < r_end valid) of a row-major matrix
  // with ld columns, columns [col0, col0 + NC) (col < ld valid)
  auto stage_rows = [&](T* dst, const T* m, int ld, int r0, int n_rows, int r_end, int col0,
                        bool vec) {
    for (int e = t; e < n_rows * (NC / 4); e += nt) {
      const int r = e / (NC / 4), c = 4 * (e % (NC / 4));
      const int row = r0 + r, col = col0 + c;
      const T* src = m + (size_t)row * ld + col;
      if (vec) {
        const bool ok = row < r_end && col < ld;
        cp4(dst + r * NC + c, ok ? src : m, ok ? 4 : 0);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = row < r_end && col + u < ld;
          cp1(dst + r * NC + c + u, ok ? src + u : m, ok);
        }
      }
    }
  };
  // ring step s: w_conv[tap, c_in chunk, c_mid chunk] or w_proj[c_mid chunk, c_out tile]
  auto stage_step = [&](int s) {
    T* dst = w_s + (s % SLOTS) * rows * NC;
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
    const T* w_slot = w_s + (s % SLOTS) * rows * NC;
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
      gemm_step<NC, T>(acc, x_s + ((tap / K) * g.in_cols + wcol(tap % K)) * XS, xoff, w_slot,
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
      project_step<NC, T>(oacc, acc, w_slot, lp, lc);
    }
  }

#pragma unroll
  for (int j = 0; j < TP; ++j) {
    const int p = (t / 32) * PPW + lp + LP * j;
    if (p >= P) continue;
    const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
    if (oh >= g.out_h || ow >= g.out_w) continue;
    T* o = out + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out;
#pragma unroll
    for (int u = 0; u < TC / 4; ++u) {
      const int co = co0 + 4 * lc + 4 * LC * u;
      if (co >= g.C_out) continue;
      const float v[4] = {oacc[j][4 * u], oacc[j][4 * u + 1], oacc[j][4 * u + 2],
                          oacc[j][4 * u + 3]};
      store_row(o + co, v, vec_o, g.C_out - co);
    }
  }
}

// grid (n_tiles, ceil(C_out / NC), B): fp32 FMAs on CUDA cores, or at bf16
// tensor cores (fusedmb_mma at c_mid chunk CM; 0 in the fp32 build),
// 32 * ceil(pixels / pixels_per_warp) threads.
template <int K, int S, int NC, int CM, typename T>
__global__ void __launch_bounds__(max_threads(NC, sizeof(T), CM), min_ctas(NC, sizeof(T), CM))
fusedmb_kernel(const T* __restrict__ x, const T* __restrict__ w_conv,
               const T* __restrict__ w_proj, T* __restrict__ out, Geom g, int act) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    fusedmb_mma<K, S, NC, CM>(x, w_conv, w_proj, out, g, act);
  else
    fusedmb_fma<K, S, NC, T>(x, w_conv, w_proj, out, g, act);
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

// The storage type of this build's C interface.
#ifdef BF16_STORAGE
using Elem = __nv_bfloat16;
#else
using Elem = float;
#endif

template <int K, int S, int NC, int CM>
cudaError_t launch(const Elem* x, const Elem* w_conv, const Elem* w_proj, Elem* out,
                   const Geom& g, int act, cudaStream_t stream) {
  const int pixels = g.tile_h * g.tile_w;
  const size_t smem = smem_bytes(g.in_rows, g.in_cols, g.ci_chunk, NC, CM, sizeof(Elem));
  // once per instance (a function-local static), so no attribute call lands
  // inside a CUDA graph capture
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      fusedmb_kernel<K, S, NC, CM, Elem>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  constexpr int PPW = pixels_per_warp(NC, sizeof(Elem), CM);
  const int threads = (pixels + PPW - 1) / PPW * 32;
  const dim3 grid(n_tiles, (g.C_out + NC - 1) / NC, g.B);
  fusedmb_kernel<K, S, NC, CM, Elem><<<grid, threads, smem, stream>>>(x, w_conv, w_proj,
                                                                       out, g, act);
  return cudaGetLastError();
}

// the c_mid chunk: 32 or 64 in the bf16 build, 0 (the chunk is NC) in fp32
template <int K, int S, int NC>
cudaError_t launch_cm(const Elem* x, const Elem* w_conv, const Elem* w_proj, Elem* out,
                      const Geom& g, int cm, int act, cudaStream_t stream) {
#ifdef BF16_STORAGE
  switch (cm) {
    case 32: return launch<K, S, NC, 32>(x, w_conv, w_proj, out, g, act, stream);
    case 64: return launch<K, S, NC, 64>(x, w_conv, w_proj, out, g, act, stream);
    default: return cudaErrorInvalidValue;
  }
#else
  return cm == 0 ? launch<K, S, NC, 0>(x, w_conv, w_proj, out, g, act, stream)
                 : cudaErrorInvalidValue;
#endif
}

template <int K, int S>
cudaError_t launch_nc(const Elem* x, const Elem* w_conv, const Elem* w_proj, Elem* out,
                      const Geom& g, int nc, int cm, int act, cudaStream_t stream) {
  switch (nc) {
    case 24: return launch_cm<K, S, 24>(x, w_conv, w_proj, out, g, cm, act, stream);
    case 32: return launch_cm<K, S, 32>(x, w_conv, w_proj, out, g, cm, act, stream);
    case 48: return launch_cm<K, S, 48>(x, w_conv, w_proj, out, g, cm, act, stream);
    case 64: return launch_cm<K, S, 64>(x, w_conv, w_proj, out, g, cm, act, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface, bound with ctypes.  fusedmb launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

// This build's tiles (core.autotune mirrors them, the wrapper checks):
// the fp32 design's pixels per thread and channel lanes (0 at bf16), the
// bf16 tensor-core design's m16 groups per warp at c_mid chunk cm and k16
// steps per ring slot (0 at fp32, whose c_mid chunk is the c_out tile).
int fusedmb_max_tile_pixels() { return MAXP; }
int fusedmb_ring_slots() { return sizeof(Elem) == 2 ? SLOTS16 : SLOTS; }
int fusedmb_pixels_per_thread() { return sizeof(Elem) == 2 ? 0 : TP; }
int fusedmb_chunk_lanes(int nc) { return sizeof(Elem) == 2 ? 0 : chunk_lanes(nc); }
int fusedmb_groups_per_warp(int cm) { return sizeof(Elem) == 2 ? groups16(cm) : 0; }
int fusedmb_k16_per_slot() { return sizeof(Elem) == 2 ? K16_SLOT : 0; }
// bytes of this build's storage type, and the dynamic shared memory one
// launch asks for (the schedule solver's budget check must agree with it)
int fusedmb_element_bytes() { return (int)sizeof(Elem); }
size_t fusedmb_smem_bytes(int in_rows, int in_cols, int ci_chunk, int nc, int cm) {
  return smem_bytes(in_rows, in_cols, ci_chunk, nc, cm, sizeof(Elem));
}
const char* fusedmb_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, w_conv, w_proj and out in this build's storage type (Elem); nc the
// c_out tile, cm the bf16 build's c_mid chunk (32 or 64; 0 in fp32).
int fusedmb(const Elem* x, const Elem* w_conv, const Elem* w_proj, Elem* out, int B,
            int H, int W, int C_in, int C_mid, int C_out, int K, int S, int out_h,
            int out_w, int pad_top, int pad_left, int tile_h, int tile_w, int nc, int cm,
            int ci_chunk, int act, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_mid = C_mid; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w; g.ci_chunk = ci_chunk;
  // a chunk smaller than C_in is a multiple of 4 (8 at bf16), so every
  // window chunk but the last is whole 4-channel (8-channel) groups
  if (B <= 0 || B > 65535 || C_in <= 0 || C_mid <= 0 || C_out <= 0 || out_h <= 0 ||
      out_w <= 0 || tile_h <= 0 || tile_w <= 0 || tile_h * tile_w > MAXP ||
      ci_chunk <= 0 || (ci_chunk < C_in && ci_chunk % (sizeof(Elem) == 2 ? 8 : 4)))
    return (int)cudaErrorInvalidValue;
  g.n_tw = (out_w + tile_w - 1) / tile_w;
  g.in_rows = (tile_h - 1) * S + K;
  g.in_cols = (tile_w - 1) * S + K;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (K * 10 + S) {
    case 31: return (int)launch_nc<3, 1>(x, w_conv, w_proj, out, g, nc, cm, act, st);
    case 32: return (int)launch_nc<3, 2>(x, w_conv, w_proj, out, g, nc, cm, act, st);
    case 51: return (int)launch_nc<5, 1>(x, w_conv, w_proj, out, g, nc, cm, act, st);
    case 52: return (int)launch_nc<5, 2>(x, w_conv, w_proj, out, g, nc, cm, act, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
