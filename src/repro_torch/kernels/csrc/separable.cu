// Depthwise-separable kernels for Hopper (sm_90a): fp32 sums, fp32 or bf16
// storage; the bf16 build of the fused kernel on bf16 tensor cores.
//
// Replaces the two Pallas TPU kernels of the JAX package's separable path:
//
//   fused_separable_kernel <- _fused_kernel (src/repro/kernels/convdk_fused.py:59),
//   fused_separable_mma       launched by fused_separable_pallas (:120), with
//                             its c_in accumulation across grid steps
//                             (:107-117) folded into the split launch (fp32
//                             and bf16 storage respectively)
//   dw2d_kernel            <- _dw2d_kernel (src/repro/kernels/convdk_dw.py:32),
//   dw2d_bf16_kernel          launched by dw2d_pallas (:57): fp32 storage, and
//                             bf16 storage
//
// What they compute (NHWC activations, w_dw (k, k, C) taps, w_pw (C_in, C_out)):
//
//   fused_separable  depthwise k x k / s -> dw_act -> pointwise 1x1 (reduce
//                    C_in) -> act, in one launch (where C_in is split too):
//                    the DW output never reaches device memory.  x, taps,
//                    w_pw and the output are fp32 or bf16 (one type per
//                    launch); every product is exact or fp32, every sum is
//                    fp32 and the output is rounded once, as the Pallas
//                    kernel widens its operands to fp32 and casts once to
//                    o_ref.dtype.
//   dw2d             depthwise k x k / s over pre-staged overlapping row strips
//                    (B, n_th, in_rows, W_pad, C) -> (B, n_th, tile_h, out_w, C),
//                    fp32 or bf16 in and out with fp32 sums, the staged
//                    baseline's DW stage (the strips are written to device
//                    memory by the wrapper, as the paper's baseline pays).
//
// Design of fused_separable in fp32 (fused_separable_kernel<K, S, NC,
// float>).  The Pallas grid (b, strip, c_out-blk, c_in-blk) carries the
// pointwise reduction across sequential c_in steps in a VMEM accumulator;
// CTAs have no order.  A CTA owns one batch element, one tile_h x tile_w
// output tile (at most MAXP pixels), one c_out tile of NC channels and one
// split of C_in: a run of whole CI-channel chunks.  The chunks stream
// through a three-slot cp.async ring (the halo'd input window of the
// chunk, its taps and its (CI, NC) pointwise rows), loaded one chunk ahead
// of the depthwise that reads them.  Per chunk the CTA computes the
// depthwise conv + dw_act into one half of a double-buffered (pixels, CI)
// shared tile (one pixel x 4 channels per item, the taps read as float4)
// while the previous chunk's half is multiplied into register accumulators
// with fusedmb.cu's GEMM step (4 pixels x NC / LC channels per thread):
// one barrier per chunk, since at MobileNet-V2's widths a chunk is a few
// microseconds of work and its barriers and latencies weigh as much as its
// FMAs.  The late MobileNet-V2 blocks (28x28 / s2 to 7x7) have too few
// pixels to fill 132 SMs, so the solver (core.autotune.select_fused_schedule)
// picks small tiles and splits C_in across CTAs: each split writes its fp32
// partial product, and the last of the splits' CTAs of each (pixel tile,
// c_out tile, image) to arrive at its counter (B4', folded in: splitk.cuh)
// sums the partials in split order, applies act and writes the output (no
// atomics on values: results repeat bit for bit), with all of its threads,
// though only the pointwise warps hold products.  The splits are bounded by
// splits * C_out < C_in, so the partials move fewer bytes than the
// depthwise tensor the staged route writes.  Where C_in is not split the
// CTA applies act and writes the output itself.  The depthwise is
// recomputed per c_out tile, as the Pallas grid does (c_out-blk outside
// c_in-blk): k*k FMAs per channel, against NC for the pointwise.
//
// Design of fused_separable in bf16 (fused_separable_mma<K, S, NJW>).  The
// same ring, chunks and one barrier per chunk, with bf16 windows, taps and
// pointwise rows (8 channels a 16-byte copy; a window pixel padded to 40
// elements and a pointwise row to an odd number of 16-byte units, so
// ldmatrix's 8 rows fall in 8 bank groups).  The depthwise runs in fp32 on
// CUDA cores, one pixel x 8 channels an item (one 16-byte load of window
// and taps, widened exactly), and writes dw_act of it split exactly into
// three bf16 terms (bf16x3_split2: hi + mid + lo == the fp32 value) into
// three (pixels, CI) planes.  The pointwise runs on bf16 tensor cores
// (mma.sync m16n8k16, fp32 sums; mma.cuh): M the tile's pixels in m16 row
// groups (rows past the tile read its last pixel and are never written), N
// the c_out tile (any multiple of 8 up to MAX_NC16, so one CTA covers
// MobileNet-V2's C_out up to 160 and the depthwise is recomputed for fewer
// c_out tiles), K the chunk; three mmas on each B fragment add hi w + mid w
// + lo w, each product exact in fp32, so the fp32 depthwise is never
// rounded to one bf16.  Four warps each own one m16 group and a run of n8
// tiles (mma_col_warps(P) warps share a group on tiles of at most 32
// pixels).  The C_in splits of one (pixel tile, c_out tile, image) are the
// CTAs of one thread-block cluster (at most MAX_CLUSTER, the portable
// size): after its chunks each rank stores its fp32 product tile in its
// own shared memory, and after a cluster barrier each rank sums its share
// of the tile's pixels over ranks 0 .. splits - 1 in rank order through
// distributed shared memory, applies act and writes the output, rounded
// once.  No partial reaches device memory (unless the caller asks for the
// ranks' products) and no counter is needed; the sum's order is fixed, so
// results repeat bit for bit.  HMMA's fp32 additions round in another order
// than FMAs, so the bf16 build is held to 1 bf16 ulp of the plain fp32 sum.
//
// Design of dw2d in fp32 (dw2d_kernel).  One CTA per (channel block of 32,
// strip, batch element); each thread keeps the k*k taps of its 4 channels
// in registers and walks the strip's output pixels, reading the strips
// straight from device memory (one 16-byte load per 4 channels when C % 4
// == 0, else scalar loads) and writing each output once.  The k*k re-reads
// of each input hit L1/L2.
//
// Design of dw2d in bf16 (dw2d_bf16_kernel).  The fp32 design at half the
// bytes waits on latency: 8-byte loads, k*k of them per output, and on
// MobileNet-V2's 112x112 block (C 32) 56 CTAs for 132 SMs.  Here a thread
// owns 8 channels (one 16-byte load or store) and a run of R = 1, 2 or 4
// consecutive output pixels of one row; per kernel row it loads the run's
// (R - 1) * s + k input columns, all before its FMAs, widens each once
// (exactly) and adds it into every output that reads it, so each output's
// sum is one fmaf chain from 0 in the fp32 kernel's order (kh outer, kw
// inner) and the bf16 output is bit for bit the fp32 kernel's output on the
// widened values, rounded once.  CTAs are cut from the output, not from the
// strip: a CTA covers a block of channels, a few rows of one strip and a
// number of runs along them (the launch's plan, solved by the caller:
// kernels.convdk_dw.dw2d_bf16_plan, fitted to a card sweep), so the
// 112x112 block launches hundreds of CTAs.  A CTA window staged in shared
// memory by cp.async (each input byte out of L2 once per CTA) was swept
// beside this and lost on every MobileNet-V2 block.  Ragged channels (C % 8
// != 0) take element loads; runs past out_w and rows past tile_h are
// masked.
//
// SAME padding is a bounds mask in fused_separable (cp.async zero-fills an
// input pixel outside the image; stride 2 puts the extra pad at the
// bottom/right, the wrapper passes the top/left pads); dw2d gets padded
// strips.  Ragged pixel and channel edges are masked here in both; the
// wrappers pad no channel.
//
// Bound.  On MobileNet-V2 at 224 fused_separable is bound by bytes on the
// 112x112 to 28x28 blocks and by operations (C_in C_out products per output
// pixel) on the 14x14 and 7x7 ones; at batch 8 every block is a few
// microseconds of work, so CTA start-up and per-chunk latency weigh as
// much as either: the bf16 build's clusters give the late blocks CTAs
// without device-memory partials.  dw2d does k*k FMAs per 8 (fp32) or 4
// (bf16) bytes moved and is bound by bytes; with too few bytes in flight it
// is bound by latency instead, which the bf16 design's 16-byte loads, runs
// and CTA count address.  The fp32 kernels use fp32 FMA
// on CUDA cores, no tensor cores and no TF32 (the JAX suite's 1e-4 fp32
// bar).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#include "mma.cuh"
#include "splitk.cuh"

namespace cg = cooperative_groups;

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
constexpr int XS = CI + 4;              // floats per depthwise-tile pixel (float4 stride odd)
constexpr int TP = 4;                   // pointwise pixels per thread
constexpr int SLOTS = 3;                // cp.async ring: two chunks in flight
constexpr int FS_THREADS = 128;

// elements of T per staged window pixel: fp32 XS; bf16 CI + 8 (80 bytes,
// an odd number of 16-byte units)
template <typename T>
__host__ __device__ constexpr int x_stride() { return sizeof(T) == 4 ? XS : CI + 8; }
// elements of T one vector cp.async moves (16 bytes)
template <typename T>
__host__ __device__ constexpr int vec_elems() { return 16 / (int)sizeof(T); }

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

// VE elements of T from src to dst where ok (one 16-byte cp.async), else
// zeros; or, where !vec, each of them alone, element u valid below n
template <typename T>
__device__ __forceinline__ void stage_elems(T* dst, const T* src, const T* base, bool vec,
                                            bool ok, int n) {
  constexpr int VE = vec_elems<T>();
  if (vec) {
    cp_async<16>(dst, ok ? src : base, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int u = 0; u < VE; ++u) cp1(dst + u, ok && u < n ? src + u : base, ok && u < n);
  }
}

// acc[j][c] += sum_k a[j][k] * b[k][c] over n4 * 4 rows k (fusedmb.cu's
// GEMM step): a row j at a_s + aoff[j], b row k at b_s + k * NC, its 4
// columns a lane reads widened to fp32 (ld4)
template <int NC, typename T>
__device__ __forceinline__ void gemm_step(float (&acc)[TP][NC / chunk_lanes(NC)],
                                          const float* __restrict__ a_s,
                                          const int (&aoff)[TP],
                                          const T* __restrict__ b_s, int lc, int n4) {
  constexpr int LC = chunk_lanes(NC), TC = NC / LC;
  const T* b0 = b_s + 4 * lc;
#pragma unroll 2
  for (int c4 = 0; c4 < n4; ++c4) {
    float4 a[TP];
#pragma unroll
    for (int j = 0; j < TP; ++j)
      a[j] = *reinterpret_cast<const float4*>(a_s + aoff[j] + 4 * c4);
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

// one ring slot, in elements of T: the window (Q x x_stride), the taps
// (K*K x CI), the pointwise rows (CI x NC); then two fp32 (pixels, XS)
// depthwise tiles
template <typename T>
__host__ __device__ size_t slot_elems(int K, int in_rows, int in_cols, int NC) {
  return (size_t)in_rows * in_cols * x_stride<T>() + (size_t)K * K * CI + (size_t)CI * NC;
}

template <typename T>
size_t smem_bytes(int K, int in_rows, int in_cols, int pixels, int NC) {
  return SLOTS * slot_elems<T>(K, in_rows, in_cols, NC) * sizeof(T) +
         2 * (size_t)pixels * XS * sizeof(float);
}

// grid (n_tiles, n_co * splits, B), FS_THREADS threads.  x, w_dw, w_pw
// and out are of the storage type T (float; the bf16 build is
// fused_separable_mma); out is the block output (B, out_h, out_w, C_out).  With splits > 1 each split CTA
// writes its fp32 product to partial (splits, B, out_h, out_w, C_out) and
// the last of a (tile, c_out tile, image)'s split CTAs to arrive at its
// counter (counters + (b * n_co + c_out tile) * n_tiles + tile) writes
// act(the split-order sum), rounded once to T, to out; partial and
// counters are null where splits == 1.
template <int K, int S, int NC, typename T>
__global__ void __launch_bounds__(FS_THREADS, 4)
fused_separable_kernel(const T* __restrict__ x, const T* __restrict__ w_dw,
                       const T* __restrict__ w_pw, float* __restrict__ partial,
                       int* __restrict__ counters, T* __restrict__ out, Geom g,
                       int dw_act, int act) {
  constexpr int LC = chunk_lanes(NC), TC = NC / LC, LP = 32 / LC;
  constexpr int PPW = pixels_per_warp(NC);
  constexpr int KK = K * K;
  constexpr int XT = x_stride<T>(), VE = vec_elems<T>();

  const int P = g.tile_h * g.tile_w, Q = g.in_rows * g.in_cols;
  const int slot = (int)slot_elems<T>(K, g.in_rows, g.in_cols, NC);
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);              // SLOTS x slot
  float* e_s = reinterpret_cast<float*>(ring + SLOTS * slot);   // 2 x P x XS

  const int tile = blockIdx.x, b = blockIdx.z;
  const int co_t = blockIdx.y % g.n_co, co0 = co_t * NC, split = blockIdx.y / g.n_co;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x, warp = t / 32;
  const int lane = t % 32, lp = lane / LC, lc = lane % LC;
  const int pw_warps = (P + PPW - 1) / PPW;
  const int n_chunks = (g.C_in + CI - 1) / CI;
  const int c_lo = split * g.split_chunks;
  const int c_hi = min(n_chunks, c_lo + g.split_chunks);
  // 16-byte staging copies where the rows come in whole ones; 4-wide
  // output stores and fold where C_out comes in fours
  const bool vec_i = g.C_in % VE == 0, vec_pw = g.C_out % VE == 0;
  const bool vec_o = g.C_out % 4 == 0;

  // chunk c (channels [CI * c, + CI), 0 past C_in) into ring slot s
  auto stage = [&](int c, int s) {
    T* xw = ring + s * slot;
    T* taps = xw + Q * XT;
    T* pw = taps + KK * CI;
    const int ci0 = c * CI;
    for (int e = t; e < Q * (CI / VE); e += FS_THREADS) {
      const int q = e / (CI / VE), ch = VE * (e % (CI / VE));
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const T* src = x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + ch;
      stage_elems(xw + q * XT + ch, src, x, vec_i, in && ci0 + ch < g.C_in,
                  g.C_in - ci0 - ch);
    }
    for (int e = t; e < KK * (CI / VE); e += FS_THREADS) {
      const int tap = e / (CI / VE), ch = VE * (e % (CI / VE));
      stage_elems(taps + tap * CI + ch, w_dw + (size_t)tap * g.C_in + ci0 + ch, w_dw, vec_i,
                  ci0 + ch < g.C_in, g.C_in - ci0 - ch);
    }
    for (int e = t; e < CI * (NC / VE); e += FS_THREADS) {
      const int r = e / (NC / VE), col = VE * (e % (NC / VE));
      stage_elems(pw + r * NC + col, w_pw + (size_t)(ci0 + r) * g.C_out + co0 + col, w_pw,
                  vec_pw, ci0 + r < g.C_in && co0 + col < g.C_out, g.C_out - co0 - col);
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

  // chunk c's depthwise + dw_act into its half of the fp32 depthwise tile,
  // one pixel x 4 channels per item (window and taps widened from T);
  // channels past C_in are 0 (dw_act(0) need not be)
  auto depthwise = [&](int c) {
    const T* xw = ring + ((c - c_lo) % SLOTS) * slot;
    const T* taps = xw + Q * XT;
    float* e = e_s + ((c - c_lo) % 2) * P * XS;
    const int nci = min(CI, g.C_in - c * CI);
    for (int i = t; i < P * (CI / 4); i += FS_THREADS) {
      const int p = i / (CI / 4), ch = 4 * (i % (CI / 4));
      const T* xp = xw + ((p / g.tile_w) * S * g.in_cols + (p % g.tile_w) * S) * XT + ch;
      float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float4 v = ld4(xp + (kh * g.in_cols + kw) * XT);
          const float4 w = ld4(taps + (kh * K + kw) * CI + ch);
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
      const T* pw = ring + ((c - c_lo) % SLOTS) * slot + Q * XT + KK * CI;
      gemm_step<NC>(acc, e_s + ((c - c_lo) % 2) * P * XS, eoff, pw, lc, CI / 4);
    }
  }

  const size_t count = (size_t)g.B * g.out_h * g.out_w * g.C_out;
  if (warp < pw_warps) {
#pragma unroll
    for (int j = 0; j < TP; ++j) {
      const int p = warp * PPW + lp + LP * j;
      if (p >= P) continue;
      const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
      if (oh >= g.out_h || ow >= g.out_w) continue;
      const size_t at = ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out;
#pragma unroll
      for (int u = 0; u < TC / 4; ++u) {
        const int co = co0 + 4 * lc + 4 * LC * u;
        if (g.splits > 1) {             // the fp32 partial, no act
          float* o = partial + split * count + at;
          if (vec_o && co < g.C_out) {
            *reinterpret_cast<float4*>(o + co) =
                make_float4(acc[j][4 * u], acc[j][4 * u + 1], acc[j][4 * u + 2],
                            acc[j][4 * u + 3]);
          } else if (!vec_o) {
#pragma unroll
            for (int v = 0; v < 4; ++v)
              if (co + v < g.C_out) o[co + v] = acc[j][4 * u + v];
          }
        } else if (co < g.C_out) {      // act, rounded once to T
          const float v[4] = {act_apply(acc[j][4 * u], act), act_apply(acc[j][4 * u + 1], act),
                              act_apply(acc[j][4 * u + 2], act),
                              act_apply(acc[j][4 * u + 3], act)};
          store_row(out + at + co, v, vec_o, g.C_out - co);
        }
      }
    }
  }
  if (g.splits == 1) return;

  // ---- the split fold (B4'): the last of the splits' CTAs of this (tile,
  // c_out tile, image) sums their partials in split order, then act ----
  __syncthreads();                      // this CTA's partials stored; the ring read
  int* last = reinterpret_cast<int*>(smem4);
  if (t == 0)
    *last = count_in(counters + ((size_t)b * g.n_co + co_t) * gridDim.x + tile, g.splits);
  __syncthreads();
  if (!*last) return;
  // 2 items x 4 splits in flight a thread, under the 128-register cap
  fold_tile<2, 4>(
      partial, out, count, g.splits, P, NC, g.C_out - co0, vec_o, t, FS_THREADS,
      [&](int p) -> long long {
        const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
        return oh < g.out_h && ow < g.out_w
                   ? ((long long)(b * g.out_h + oh) * g.out_w + ow) * g.C_out + co0
                   : -1;
      },
      [&](float v) { return act_apply(v, act); });
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

template <int K, int S, int NC, typename T>
cudaError_t launch_fused(const T* x, const T* w_dw, const T* w_pw, float* partial,
                         int* counters, T* out, const Geom& g, int dw_act, int act,
                         cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(K, g.in_rows, g.in_cols, g.tile_h * g.tile_w, NC);
  // once per instance (a function-local static), so no attribute call lands
  // inside a CUDA graph capture
  static const cudaError_t smem_set = cudaFuncSetAttribute(
      fused_separable_kernel<K, S, NC, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  const dim3 grid(n_tiles, g.n_co * g.splits, g.B);
  fused_separable_kernel<K, S, NC, T><<<grid, FS_THREADS, smem, stream>>>(
      x, w_dw, w_pw, partial, counters, out, g, dw_act, act);
  return cudaGetLastError();
}

template <int K, int S, typename T>
cudaError_t launch_fused_nc(const void* x, const void* w_dw, const void* w_pw,
                            float* partial, int* counters, void* out, const Geom& g,
                            int nc, int dw_act, int act, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dt = static_cast<const T*>(w_dw);
  const T* pt = static_cast<const T*>(w_pw);
  T* ot = static_cast<T*>(out);
#define FUSED_NC(NC_)                                                                   \
  case NC_:                                                                             \
    return launch_fused<K, S, NC_, T>(xt, dt, pt, partial, counters, ot, g, dw_act, act, \
                                      stream);
  switch (nc) {
    FUSED_NC(16)
    FUSED_NC(24)
    FUSED_NC(32)
    FUSED_NC(48)
    FUSED_NC(64)
    default: return cudaErrorInvalidValue;
  }
#undef FUSED_NC
}

template <typename T>
cudaError_t launch_fused_ks(const void* x, const void* w_dw, const void* w_pw,
                            float* partial, int* counters, void* out, const Geom& g,
                            int K, int S, int nc, int dw_act, int act, cudaStream_t st) {
#define FUSED_KS(K_, S_)                                                                \
  case K_ * 10 + S_:                                                                    \
    return launch_fused_nc<K_, S_, T>(x, w_dw, w_pw, partial, counters, out, g, nc,    \
                                      dw_act, act, st);
  switch (K * 10 + S) {
    FUSED_KS(3, 1)
    FUSED_KS(3, 2)
    FUSED_KS(5, 1)
    FUSED_KS(5, 2)
    default: return cudaErrorInvalidValue;
  }
#undef FUSED_KS
}

// ------------------------- fused_separable, bf16 build -------------------------

constexpr int TS = CI + 8;              // bf16 per depthwise-term row (80 bytes)
constexpr int MAX_NC16 = 160;           // widest c_out tile of the bf16 build
constexpr int MAX_CLUSTER = 8;          // C_in splits: the portable cluster size
constexpr int NJ_BLOCK = 8;             // n8 tiles whose B fragments a warp holds at once

// warps across the c_out tile: each warp owns one m16 row group of the
// tile's pixels and a run of n8 tiles, so 4 / mma_col_warps(P) groups cover
// the P <= MAXP pixels
__host__ __device__ constexpr int mma_col_warps(int pixels) {
  return pixels <= 16 ? 4 : pixels <= 32 ? 2 : 1;
}
// bf16 per pointwise ring row at c_out tile nc: an odd number of 16-byte units
__host__ __device__ constexpr int mma_row_stride(int nc) { return (nc / 8) % 2 ? nc : nc + 8; }

// one ring slot of the bf16 build, in bf16: the window (Q x x_stride), the
// taps (K*K x CI), the pointwise rows (CI x mma_row_stride(nc))
__host__ __device__ inline size_t mma_slot_elems(int K, int in_rows, int in_cols, int nc) {
  return (size_t)in_rows * in_cols * x_stride<__nv_bfloat16>() + (size_t)K * K * CI +
         (size_t)CI * mma_row_stride(nc);
}

// the ring and two sets of the depthwise tile's three bf16 terms (pixels x
// TS each); after the chunks the same bytes hold the fp32 (pixels, nc + 4)
// product tile the cluster's fold reads
size_t mma_smem_bytes(int K, int in_rows, int in_cols, int pixels, int nc) {
  const size_t ring = SLOTS * mma_slot_elems(K, in_rows, in_cols, nc) * sizeof(__nv_bfloat16) +
                      2 * 3 * (size_t)pixels * TS * sizeof(__nv_bfloat16);
  const size_t fold = (size_t)pixels * (nc + 4) * sizeof(float);
  return ring > fold ? ring : fold;
}

// 8 bf16 (one 16-byte word) widened exactly to fp32: a bf16 is the top half
// of the fp32 word of the same value
__device__ __forceinline__ void widen8(const uint4& v, float (&f)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    f[2 * u] = __uint_as_float(w[u] << 16);
    f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}

// grid (n_tiles * splits, ceil(C_out / nc), B) in clusters of `splits` CTAs
// along x, FS_THREADS threads.  Rank r of a cluster sums the r-th run of
// g.split_chunks whole chunks of C_in for one (pixel tile, c_out tile,
// image); the ranks' fp32 products meet in distributed shared memory, where
// each rank sums its share of the tile's pixels over ranks 0 .. splits - 1
// in rank order, applies act and writes the output, rounded once.  x, w_dw,
// w_pw and out are bf16; where partial (splits, B, out_h, out_w, C_out) is
// not null each rank also stores its fp32 product there.  A warp owns NJW
// >= ceil(nc / 8 / mma_col_warps(P)) n8 tiles.
template <int K, int S, int NJW>
__global__ void __launch_bounds__(FS_THREADS, 3)
fused_separable_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w_dw,
                    const __nv_bfloat16* __restrict__ w_pw, float* __restrict__ partial,
                    __nv_bfloat16* __restrict__ out, Geom g, int nc, int dw_act, int act) {
  using T = __nv_bfloat16;
  constexpr int KK = K * K, XT = x_stride<T>(), VE = vec_elems<T>();

  const int P = g.tile_h * g.tile_w, Q = g.in_rows * g.in_cols;
  const int WC = mma_row_stride(nc), NJ = nc / 8, WN = mma_col_warps(P);
  const int slot = (int)mma_slot_elems(K, g.in_rows, g.in_cols, nc);
  extern __shared__ float4 smem4[];
  T* ring = reinterpret_cast<T*>(smem4);              // SLOTS x slot
  T* terms = ring + SLOTS * slot;                     // 2 x 3 x P x TS
  float* prod = reinterpret_cast<float*>(smem4);      // after the chunks: P x (nc + 4)

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int tile = blockIdx.x / g.splits, b = blockIdx.z, co0 = blockIdx.y * nc;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  const int n_chunks = (g.C_in + CI - 1) / CI;
  const int c_lo = split * g.split_chunks;
  const int c_hi = min(n_chunks, c_lo + g.split_chunks);
  const bool vec_i = g.C_in % VE == 0, vec_pw = g.C_out % VE == 0;

  // chunk c (channels [CI * c, + CI), 0 past C_in) into ring slot s
  auto stage = [&](int c, int s) {
    T* xw = ring + s * slot;
    T* taps = xw + Q * XT;
    T* pw = taps + KK * CI;
    const int ci0 = c * CI;
    for (int e = t; e < Q * (CI / VE); e += FS_THREADS) {
      const int q = e / (CI / VE), ch = VE * (e % (CI / VE));
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const bool in = ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const T* src = x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci0 + ch;
      stage_elems(xw + q * XT + ch, src, x, vec_i, in && ci0 + ch < g.C_in, g.C_in - ci0 - ch);
    }
    for (int e = t; e < KK * (CI / VE); e += FS_THREADS) {
      const int tap = e / (CI / VE), ch = VE * (e % (CI / VE));
      stage_elems(taps + tap * CI + ch, w_dw + (size_t)tap * g.C_in + ci0 + ch, w_dw, vec_i,
                  ci0 + ch < g.C_in, g.C_in - ci0 - ch);
    }
    for (int e = t; e < CI * (nc / VE); e += FS_THREADS) {
      const int r = e / (nc / VE), col = VE * (e % (nc / VE));
      stage_elems(pw + r * WC + col, w_pw + (size_t)(ci0 + r) * g.C_out + co0 + col, w_pw,
                  vec_pw, ci0 + r < g.C_in && co0 + col < g.C_out, g.C_out - co0 - col);
    }
  };

  // chunk c's depthwise + dw_act in fp32, split exactly into three bf16
  // terms (hi, mid, lo planes of its half of the term tiles), one pixel x 8
  // channels an item; channels past C_in are 0 (dw_act(0) need not be)
  auto depthwise = [&](int c) {
    const T* xw = ring + ((c - c_lo) % SLOTS) * slot;
    const T* taps = xw + Q * XT;
    T* dst = terms + ((c - c_lo) % 2) * 3 * P * TS;
    const int nci = min(CI, g.C_in - c * CI);
    for (int i = t; i < P * (CI / 8); i += FS_THREADS) {
      const int p = i / (CI / 8), ch = 8 * (i % (CI / 8));
      const T* xp = xw + ((p / g.tile_w) * S * g.in_cols + (p % g.tile_w) * S) * XT + ch;
      float d[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = 0.f;
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          float v[8], w[8];
          widen8(*reinterpret_cast<const uint4*>(xp + (kh * g.in_cols + kw) * XT), v);
          widen8(*reinterpret_cast<const uint4*>(taps + (kh * K + kw) * CI + ch), w);
#pragma unroll
          for (int u = 0; u < 8; ++u) d[u] = fmaf(v[u], w[u], d[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) d[u] = ch + u < nci ? act_apply(d[u], dw_act) : 0.f;
      uint4 hi, mid, lo;
      bf16x3_split2(d[0], d[1], hi.x, mid.x, lo.x);
      bf16x3_split2(d[2], d[3], hi.y, mid.y, lo.y);
      bf16x3_split2(d[4], d[5], hi.z, mid.z, lo.z);
      bf16x3_split2(d[6], d[7], hi.w, mid.w, lo.w);
      *reinterpret_cast<uint4*>(dst + p * TS + ch) = hi;
      *reinterpret_cast<uint4*>(dst + (P + p) * TS + ch) = mid;
      *reinterpret_cast<uint4*>(dst + (2 * P + p) * TS + ch) = lo;
    }
  };

  // the pointwise role: m16 row group grp (rows past the tile read pixel
  // P - 1 and are never written), n8 tiles j0 .. j0 + NJW - 1 (those past
  // the c_out tile skipped)
  const int grp = warp / WN, j0 = (warp % WN) * NJW;
  const bool mma_warp = grp * MMA_M < P;
  const int arow = min(grp * MMA_M + lane % 16, P - 1) * TS + 8 * (lane / 16);
  float acc[NJW][4];
#pragma unroll
  for (int jj = 0; jj < NJW; ++jj) acc[jj][0] = acc[jj][1] = acc[jj][2] = acc[jj][3] = 0.f;

  // chunk c's pointwise: per k16 step the three terms' A fragments, each
  // multiplied into every n8 tile (one term over the tiles, then the next)
  auto pointwise = [&](int c) {
    const T* a = terms + ((c - c_lo) % 2) * 3 * P * TS + arow;
    const T* pw = ring + ((c - c_lo) % SLOTS) * slot + Q * XT + KK * CI + (lane % 16) * WC;
#pragma unroll
    for (int kk = 0; kk < CI / 16; ++kk) {
      unsigned af[3][4];
#pragma unroll
      for (int e = 0; e < 3; ++e) ldsm_x4(af[e], a + e * P * TS + 16 * kk);
#pragma unroll
      for (int jb = 0; jb < NJW; jb += NJ_BLOCK) {
        unsigned bf[NJ_BLOCK][2];
#pragma unroll
        for (int jj = jb; jj < jb + NJ_BLOCK && jj < NJW; ++jj)
          if (j0 + jj < NJ) ldsm_x2_trans(bf[jj - jb], pw + 16 * kk * WC + 8 * (j0 + jj));
#pragma unroll
        for (int e = 0; e < 3; ++e)
#pragma unroll
          for (int jj = jb; jj < jb + NJ_BLOCK && jj < NJW; ++jj)
            if (j0 + jj < NJ) mma_bf16(acc[jj], af[e], bf[jj - jb][0], bf[jj - jb][1]);
      }
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
  // share a phase (the term tiles are double-buffered)
  for (int c = c_lo; c < c_hi; ++c) {
    cp_async_wait<0>();
    __syncthreads();                    // chunk c + 1 landed; depthwise(c) written; chunk c - 1 read
    if (c + SLOTS - 1 < c_hi) stage(c + SLOTS - 1, (c + SLOTS - 1 - c_lo) % SLOTS);
    cp_async_commit();
    if (c + 1 < c_hi) depthwise(c + 1);
    if (mma_warp) pointwise(c);
  }

  // the output offset of tile pixel p (its c_out tile's first channel), -1
  // past the image
  auto at_of = [&](int p) -> long long {
    const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
    return oh < g.out_h && ow < g.out_w
               ? ((long long)(b * g.out_h + oh) * g.out_w + ow) * g.C_out + co0
               : -1;
  };
  // accumulator element (jj, e): pixel grp * 16 + lane / 4 + 8 (e >> 1),
  // channel 8 (j0 + jj) + 2 (lane % 4) + (e & 1) of the c_out tile
  const int fr = lane / 4, fc = 2 * (lane % 4);
  const bool pair = (g.C_out & 1) == 0;
  if (g.splits == 1 || partial != nullptr) {
    const size_t count = (size_t)g.B * g.out_h * g.out_w * g.C_out;
    float* part = partial + split * count;
#pragma unroll
    for (int jj = 0; jj < NJW; ++jj) {
      const int co = 8 * (j0 + jj) + fc;
      if (!mma_warp || j0 + jj >= NJ || co0 + co >= g.C_out) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = grp * MMA_M + fr + 8 * h;
        const long long at = p < P ? at_of(p) : -1;
        if (at < 0) continue;
        const float v0 = acc[jj][2 * h], v1 = acc[jj][2 * h + 1];
        const bool two = co0 + co + 1 < g.C_out;
        if (g.splits == 1) {            // act, rounded once to bf16
          T* o = out + at + co;
          const float a0 = act_apply(v0, act), a1 = act_apply(v1, act);
          if (pair) {
            *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(a0, a1);
          } else {
            o[0] = __float2bfloat16_rn(a0);
            if (two) o[1] = __float2bfloat16_rn(a1);
          }
        } else if (pair) {              // this rank's fp32 product, no act
          *reinterpret_cast<float2*>(part + at + co) = make_float2(v0, v1);
        } else {
          part[at + co] = v0;
          if (two) part[at + co + 1] = v1;
        }
      }
    }
    if (g.splits == 1) return;
  }

  // ---- the cluster's fold: each rank's product tile into its shared
  // memory, then each rank sums its share of the pixels over the ranks in
  // rank order, ((p0 + p1) + p2) + ..., reading the others' tiles ----
  const int RS = nc + 4;
  __syncthreads();                      // the ring and term tiles read
  if (mma_warp) {
#pragma unroll
    for (int jj = 0; jj < NJW; ++jj) {
      if (j0 + jj >= NJ) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = grp * MMA_M + fr + 8 * h;
        if (p < P)
          *reinterpret_cast<float2*>(prod + p * RS + 8 * (j0 + jj) + fc) =
              make_float2(acc[jj][2 * h], acc[jj][2 * h + 1]);
      }
    }
  }
  cluster.sync();                       // every rank's tile stored and visible
  const float* ranks[MAX_CLUSTER];
#pragma unroll
  for (int q = 0; q < MAX_CLUSTER; ++q)
    ranks[q] = q < g.splits ? cluster.map_shared_rank(prod, q) : prod;
  const int share = (P + g.splits - 1) / g.splits, p0 = split * share;
  const int np = max(0, min(P, p0 + share) - p0);
  const int n4 = (min(nc, g.C_out - co0) + 3) / 4;
  const bool vec_o = g.C_out % 4 == 0;
  for (int i = t; i < np * n4; i += FS_THREADS) {
    const int p = p0 + i / n4, c4 = 4 * (i % n4);
    float4 v[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < g.splits) v[q] = *reinterpret_cast<const float4*>(ranks[q] + p * RS + c4);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < MAX_CLUSTER; ++q) {
      if (q < g.splits) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    }
    const long long at = at_of(p);
    if (at < 0) continue;
    const float o[4] = {act_apply(s.x, act), act_apply(s.y, act), act_apply(s.z, act),
                        act_apply(s.w, act)};
    store_row(out + at + c4, o, vec_o, g.C_out - co0 - c4);
  }
  cluster.sync();                       // no rank leaves while another reads its tile
}

// Clusters of a launch's configuration that fit the card at once
// (cudaOccupancyMaxActiveClusters), asked once per (device, kernel, shared
// memory, cluster size), so that no query lands inside a CUDA graph capture.
template <typename Kernel>
cudaError_t resident_clusters(Kernel kernel, const cudaLaunchConfig_t& cfg, int* n) {
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, size_t, unsigned>, std::pair<cudaError_t, int>>
      seen;
  int dev = 0;
  const cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const auto key = std::make_tuple(dev, reinterpret_cast<const void*>(kernel),
                                   cfg.dynamicSmemBytes, cfg.attrs[0].val.clusterDim.x);
  std::lock_guard<std::mutex> lock(mu);
  auto it = seen.find(key);
  if (it == seen.end()) {
    int count = 0;
    const cudaError_t q = cudaOccupancyMaxActiveClusters(&count, kernel, &cfg);
    if (q != cudaSuccess) cudaGetLastError();           // not left for a later launch
    it = seen.emplace(key, std::make_pair(q, count)).first;
  }
  *n = it->second.second;
  return it->second.first;
}

template <int K, int S, int NJW>
cudaError_t launch_mma(const __nv_bfloat16* x, const __nv_bfloat16* w_dw,
                       const __nv_bfloat16* w_pw, float* partial, __nv_bfloat16* out,
                       const Geom& g, int nc, int dw_act, int act, cudaStream_t stream) {
  const auto kernel = fused_separable_mma<K, S, NJW>;
  const size_t smem = mma_smem_bytes(K, g.in_rows, g.in_cols, g.tile_h * g.tile_w, nc);
  // once per instance, so no attribute call lands inside a graph capture
  static const cudaError_t smem_set =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const int n_tiles = ((g.out_h + g.tile_h - 1) / g.tile_h) * g.n_tw;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = g.splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * g.splits, g.n_co, g.B);
  cfg.blockDim = dim3(FS_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  const cudaError_t res = resident_clusters(kernel, cfg, &clusters);
  if (res != cudaSuccess) return res;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;   // a plan that cannot be resident
  cudaLaunchKernelEx(&cfg, kernel, x, w_dw, w_pw, partial, out, g, nc, dw_act, act);
  return cudaGetLastError();
}

// the instance whose NJW covers the c_out tile at the tile's warp layout
template <int K, int S>
cudaError_t launch_mma_nj(const void* x, const void* w_dw, const void* w_pw, float* partial,
                          void* out, const Geom& g, int nc, int dw_act, int act,
                          cudaStream_t st) {
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* dt = static_cast<const __nv_bfloat16*>(w_dw);
  const auto* pt = static_cast<const __nv_bfloat16*>(w_pw);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  const int wn = mma_col_warps(g.tile_h * g.tile_w);
  const int njw = (nc / 8 + wn - 1) / wn;
#define MMA_NJ(N_) \
  if (njw <= N_) return launch_mma<K, S, N_>(xt, dt, pt, partial, ot, g, nc, dw_act, act, st);
  MMA_NJ(1) MMA_NJ(2) MMA_NJ(3) MMA_NJ(4) MMA_NJ(5) MMA_NJ(6) MMA_NJ(8) MMA_NJ(10)
  MMA_NJ(12) MMA_NJ(16) MMA_NJ(20)
#undef MMA_NJ
  return cudaErrorInvalidValue;
}

cudaError_t launch_mma_ks(const void* x, const void* w_dw, const void* w_pw, float* partial,
                          void* out, const Geom& g, int K, int S, int nc, int dw_act, int act,
                          cudaStream_t st) {
  switch (K * 10 + S) {
    case 31: return launch_mma_nj<3, 1>(x, w_dw, w_pw, partial, out, g, nc, dw_act, act, st);
    case 32: return launch_mma_nj<3, 2>(x, w_dw, w_pw, partial, out, g, nc, dw_act, act, st);
    case 51: return launch_mma_nj<5, 1>(x, w_dw, w_pw, partial, out, g, nc, dw_act, act, st);
    case 52: return launch_mma_nj<5, 2>(x, w_dw, w_pw, partial, out, g, nc, dw_act, act, st);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------ dw2d ------------------------------------

constexpr int DW_NPL = NTHREADS / NCG;  // pixel lanes of a dw2d CTA

struct StripGeom {
  int n_th, in_rows, W_pad, C, tile_h, out_w;
};

// 4 fp32 channels at p: one 16-byte load when VEC (p aligned to it), else
// scalar loads of the first n
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

// the first n of 4 fp32 sums to p
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

// grid (ceil(C / CT), n_th, B), NTHREADS threads; VEC when C % 4 == 0.  T is
// float (x, taps and output alike; the bf16 build is dw2d_bf16_kernel).
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

// -------------------------------- dw2d in bf16 --------------------------------

constexpr int DWB_THREADS = 256;        // most threads of a dw2d_bf16 CTA

// the runs (output pixels of a row a thread) dw2d_bf16 takes
constexpr bool dw_run_ok(int R) { return R == 1 || R == 2 || R == 4; }

// One dw2d_bf16 launch's shape: R output pixels of one row a thread (run),
// 8 channels a thread; a CTA covers cpt channels (a multiple of 8), rows
// output rows of one strip and runs runs along each of them.
struct DwPlan {
  int run, cpt, rows, runs;
};

// 8 bf16 channels at p, packed: one 16-byte load when VEC (p 16-byte
// aligned), else the first n (1 <= n <= 8) one at a time and zeros
template <bool VEC>
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n) {
  if constexpr (VEC) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
    unsigned e[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) e[u] = u < n ? (unsigned)__ldg(q + u) : 0u;
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                      e[6] | e[7] << 16);
  }
}

// the first n of 8 fp32 sums to p, each rounded once to bf16 (nearest
// even): one 16-byte store when VEC
template <bool VEC>
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8], int n) {
  if constexpr (VEC) {
    unsigned u[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      u[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (u < n) p[u] = __float2bfloat16_rn(v[u]);
  }
}

// grid (n_cb * ceil(ceil(out_w / R) / runs), n_th * n_rb, B), cpt / 8 *
// rows * runs threads: n_cb channel blocks, n_rb row blocks a strip.  A
// thread (its channel group fastest, then its run, then its row) computes R
// consecutive outputs of one row for 8 channels.  Per kernel row it loads
// the run's (R - 1) * S + K input columns, all before any FMA, widens each
// once and adds it into every output that reads it; taken in ascending
// column, each output's sum is one fmaf chain from 0 in the fp32 kernel's
// order (kh outer, kw inner).  Columns past the strip are read only by
// outputs past out_w, and load as zeros.  VEC when C % 8 == 0 and every
// pointer is 16-byte aligned.
template <int K, int S, int R, bool VEC>
__global__ void __launch_bounds__(DWB_THREADS)
dw2d_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, StripGeom g, DwPlan p, int n_cb, int n_rb) {
  constexpr int NCOL = (R - 1) * S + K;
  const int n_cg = p.cpt / 8, rest = threadIdx.x / n_cg;
  const int c = (blockIdx.x % n_cb) * p.cpt + (threadIdx.x % n_cg) * 8;
  const int orow = (blockIdx.y % n_rb) * p.rows + rest / p.runs;
  const int ow0 = ((blockIdx.x / n_cb) * p.runs + rest % p.runs) * R;
  if (c >= g.C || orow >= g.tile_h || ow0 >= g.out_w) return;   // no barrier
  const int n = min(8, g.C - c);
  const size_t strip = (size_t)blockIdx.z * g.n_th + blockIdx.y / n_rb;
  const __nv_bfloat16* xs =
      x + ((strip * g.in_rows + orow * S) * g.W_pad + (size_t)ow0 * S) * g.C + c;
  const int cols = min(NCOL, g.W_pad - ow0 * S);   // the run's columns in the strip
  float acc[R][8] = {};
#pragma unroll
  for (int kh = 0; kh < K; ++kh) {
    uint4 xv[NCOL];
#pragma unroll
    for (int j = 0; j < NCOL; ++j)
      xv[j] = j < cols ? load8<VEC>(xs + ((size_t)kh * g.W_pad + j) * g.C, n)
                       : make_uint4(0u, 0u, 0u, 0u);
    float wt[K][8];
#pragma unroll
    for (int kw = 0; kw < K; ++kw) widen8(load8<VEC>(w + (size_t)(kh * K + kw) * g.C + c, n), wt[kw]);
#pragma unroll
    for (int j = 0; j < NCOL; ++j) {
      float xf[8];
      widen8(xv[j], xf);
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const int d = j - kw;           // r * S for the output r it feeds
        if (d < 0 || d % S != 0 || d / S >= R) continue;
#pragma unroll
        for (int u = 0; u < 8; ++u) acc[d / S][u] = fmaf(xf[u], wt[kw][u], acc[d / S][u]);
      }
    }
  }
  __nv_bfloat16* os = out + ((strip * g.tile_h + orow) * g.out_w + ow0) * g.C + c;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (ow0 + r < g.out_w) store8<VEC>(os + (size_t)r * g.C, acc[r], n);
}

template <int K, int S, int R>
cudaError_t launch_dw2d_bf16_r(const __nv_bfloat16* x, const __nv_bfloat16* w,
                               __nv_bfloat16* out, int B, const StripGeom& g, const DwPlan& p,
                               bool vec, cudaStream_t stream) {
  const int n_cb = (g.C + p.cpt - 1) / p.cpt, n_rb = (g.tile_h + p.rows - 1) / p.rows;
  const int n_runs = (g.out_w + R - 1) / R;
  const long long gx = (long long)n_cb * ((n_runs + p.runs - 1) / p.runs);
  const long long gy = (long long)g.n_th * n_rb;
  if (gx > 0x7fffffffLL || gy > 65535) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy, B);
  const int threads = p.cpt / 8 * p.rows * p.runs;
  if (vec)
    dw2d_bf16_kernel<K, S, R, true><<<grid, threads, 0, stream>>>(x, w, out, g, p, n_cb, n_rb);
  else
    dw2d_bf16_kernel<K, S, R, false><<<grid, threads, 0, stream>>>(x, w, out, g, p, n_cb, n_rb);
  return cudaGetLastError();
}

template <int K, int S>
cudaError_t launch_dw2d_bf16_ks(const __nv_bfloat16* x, const __nv_bfloat16* w,
                                __nv_bfloat16* out, int B, const StripGeom& g,
                                const DwPlan& p, bool vec, cudaStream_t st) {
  switch (p.run) {
    case 1: return launch_dw2d_bf16_r<K, S, 1>(x, w, out, B, g, p, vec, st);
    case 2: return launch_dw2d_bf16_r<K, S, 2>(x, w, out, B, g, p, vec, st);
    case 4: return launch_dw2d_bf16_r<K, S, 4>(x, w, out, B, g, p, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_dw2d_bf16(const void* x, const void* w, void* out, int B, int K, int S,
                             const StripGeom& g, const DwPlan& p, cudaStream_t st) {
  const auto* xt = static_cast<const __nv_bfloat16*>(x);
  const auto* wt = static_cast<const __nv_bfloat16*>(w);
  auto* ot = static_cast<__nv_bfloat16*>(out);
  if (!dw_run_ok(p.run) || p.cpt <= 0 || p.cpt % 8 || p.rows <= 0 || p.runs <= 0 ||
      p.cpt / 8 * p.rows * p.runs > DWB_THREADS)
    return cudaErrorInvalidValue;
  const bool vec = g.C % 8 == 0 && (reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(w) |
                                    reinterpret_cast<size_t>(out)) % 16 == 0;
  switch (K * 10 + S) {
    case 31: return launch_dw2d_bf16_ks<3, 1>(xt, wt, ot, B, g, p, vec, st);
    case 32: return launch_dw2d_bf16_ks<3, 2>(xt, wt, ot, B, g, p, vec, st);
    case 51: return launch_dw2d_bf16_ks<5, 1>(xt, wt, ot, B, g, p, vec, st);
    case 52: return launch_dw2d_bf16_ks<5, 2>(xt, wt, ot, B, g, p, vec, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The C interface, bound with ctypes.  Each launcher launches on `stream` and
// returns cudaGetLastError() after the launch (0 = launched).
extern "C" {

int fused_separable_max_tile_pixels() { return MAXP; }
int fused_separable_ci_chunk() { return CI; }
// elements of the storage type per staged window pixel (bf16 = 0: fp32)
int fused_separable_pixel_stride(int bf16) {
  return bf16 ? x_stride<__nv_bfloat16>() : x_stride<float>();
}
int fused_separable_threads() { return FS_THREADS; }
int fused_separable_chunk_lanes(int nc) { return chunk_lanes(nc); }
// the bf16 build's tiles: its widest c_out tile, its largest cluster (C_in
// splits), the bf16 per depthwise-term row and the warps across the c_out
// tile at a tile of `pixels`
int fused_separable_max_out_tile_bf16() { return MAX_NC16; }
int fused_separable_max_cluster() { return MAX_CLUSTER; }
int fused_separable_term_stride() { return TS; }
int fused_separable_col_warps(int pixels) { return mma_col_warps(pixels); }
// the dynamic shared memory one fused_separable launch asks for (the
// schedule solver's budget check must agree with it)
size_t fused_separable_smem_bytes(int K, int in_rows, int in_cols, int pixels, int nc,
                                  int bf16) {
  return bf16 ? mma_smem_bytes(K, in_rows, in_cols, pixels, nc)
              : smem_bytes<float>(K, in_rows, in_cols, pixels, nc);
}
const char* separable_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// x, w_dw, w_pw and out all fp32 (bf16 = 0) or all bf16 (bf16 = 1); out
// is the block output.  fp32: for splits > 1 partial is the (splits, B,
// out_h, out_w, C_out) fp32 scratch of the split products and counters
// holds n_tiles * ceil(C_out / nc) * B zeros (left so), else both are
// null.  bf16 (fused_separable_mma, the splits a cluster): counters is
// null, and partial, null or (for splits > 1) that tensor, receives the
// ranks' products.
int fused_separable(const void* x, const void* w_dw, const void* w_pw, float* partial,
                    int* counters, void* out, int B, int H, int W, int C_in, int C_out,
                    int K, int S, int out_h, int out_w, int pad_top, int pad_left,
                    int tile_h, int tile_w, int nc, int splits, int dw_act, int act,
                    int bf16, void* stream) {
  Geom g;
  g.B = B; g.H = H; g.W = W; g.C_in = C_in; g.C_out = C_out;
  g.out_h = out_h; g.out_w = out_w; g.pad_top = pad_top; g.pad_left = pad_left;
  g.tile_h = tile_h; g.tile_w = tile_w;
  const int n_chunks = (C_in + CI - 1) / CI;
  if (B <= 0 || B > 65535 || C_in <= 0 || C_out <= 0 || out_h <= 0 || out_w <= 0 ||
      tile_h <= 0 || tile_w <= 0 || tile_h * tile_w > MAXP || splits <= 0 ||
      splits > n_chunks || !out)
    return (int)cudaErrorInvalidValue;
  if (bf16 ? nc <= 0 || nc % 8 || nc > MAX_NC16 || splits > MAX_CLUSTER || counters ||
                 (splits == 1 && partial)
           : chunk_lanes(nc) == 0 || (splits > 1) != (partial != nullptr) ||
                 (splits > 1) != (counters != nullptr))
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
  const cudaStream_t st = (cudaStream_t)stream;
  return (int)(bf16 ? launch_mma_ks(x, w_dw, w_pw, partial, out, g, K, S, nc, dw_act, act, st)
                    : launch_fused_ks<float>(x, w_dw, w_pw, partial, counters, out, g, K,
                                             S, nc, dw_act, act, st));
}

// x_strips, w and out all fp32 (bf16 = 0: dw2d_kernel, the plan's four ints
// 0) or all bf16 (bf16 = 1: dw2d_bf16_kernel at the plan (run, cpt, rows,
// runs), which the caller solves; a plan it cannot launch returns
// cudaErrorInvalidValue)
int dw2d(const void* x_strips, const void* w, void* out, int B, int n_th, int in_rows,
         int W_pad, int C, int K, int S, int tile_h, int out_w, int bf16, int run, int cpt,
         int rows, int runs, void* stream) {
  StripGeom g;
  g.n_th = n_th; g.in_rows = in_rows; g.W_pad = W_pad; g.C = C;
  g.tile_h = tile_h; g.out_w = out_w;
  if (B <= 0 || B > 65535 || n_th <= 0 || n_th > 65535 || C <= 0 || tile_h <= 0 ||
      out_w <= 0 || in_rows != (tile_h - 1) * S + K || W_pad < (out_w - 1) * S + K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (!bf16) {
    if (run || cpt || rows || runs) return (int)cudaErrorInvalidValue;
    return (int)launch_dw2d_k<float>(x_strips, w, out, B, K, S, g, st);
  }
  DwPlan p;
  p.run = run; p.cpt = cpt; p.rows = rows; p.runs = runs;
  return (int)launch_dw2d_bf16(x_strips, w, out, B, K, S, g, p, st);
}

}  // extern "C"
