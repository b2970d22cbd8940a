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
//   mbconv_splitk_reduce_kernel    <- the c_mid accumulation across grid
//                                     steps of _mbconv_pass2_retain_kernel
//                                     (:245-251)
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
//   split-K    sums retain's per-split partial products in split order.
//
// The Pallas grids reduce over *sequential* grid steps (c_in innermost,
// c_mid for the projection, strips for the pool); CTAs have no order, so a
// reduction either loops inside one CTA or goes through partials plus a
// second kernel that sums them in a fixed order.  SAME padding is a bounds
// mask everywhere: an input pixel outside the image reads as 0, so its
// expanded value is exp_act(0), exactly what the JAX kernel's zero-padded
// input gives.  Ragged pixels, channels and rows are masked in the kernels;
// the wrappers pad nothing.  fp32 FMA on CUDA cores, no tensor cores: a
// 1xTF32 product misses the JAX suite's 1e-4 fp32 bar.
//
// Pass 1 (bound by operations: the expand contraction over the halo'd
// window; at B0's early blocks, with C_in 16-40, by per-pixel work and
// latency).  One CTA owns a tile_h x tile_w output tile (up to P1_MAXP
// pixels: core.autotune gives retain blocks the tile that expands the
// fewest window pixels while three CTAs fit an SM and the launch fills a
// wave; recompute blocks keep B2's tile) and a c_mid tile of 64 channels
// (32 where 64-wide tiles would pad C_mid by more than an eighth), so each
// staged input value serves up to 64 channels.  The input window is staged P1_CI channels at a time, with
// the matching w_exp rows, by 16-byte cp.async copies into a P1_SLOTS ring
// (one barrier per chunk); the pixel stride is padded against bank
// conflicts.  The expand is a small GEMM (window pixels x C_in -> c_mid
// tile): each thread keeps NB register blocks of 4 pixels x 4 channels of
// independent sums across all of C_in (NB = 1, 2 or 4, whatever covers the
// window in one pass; a larger window takes several passes), reading
// float4s of both operands from shared memory, and writes the activated
// window to shared memory once.  The DW taps then run out of that window,
// one channel per thread over a run of 4 output pixels of a row, so each
// loaded input column serves up to 4 outputs.  The DW tile goes back into
// the staging region, which gives the pool partials as column sums and the
// retained DW tensor as float4 stores along C_mid.
//
// Retain (the projection is a GEMM: M = B * out_h * out_w rows, K = C_mid,
// N = C_out; bound by operations, and in practice by latency at B0's
// sizes).  It has no halo, so (B, out_h, out_w) flattens into M and rows
// of different images share a CTA.  Each CTA owns a BM x BN tile; K goes in
// R_BK-deep chunks, staged by 16-byte cp.async copies into an R_STAGES ring.
// As a chunk of A is consumed it is multiplied by the SE gate of its row's
// image (m / (out_h * out_w)), loaded into registers a chunk ahead, which
// rounds d * gate before the product as the plain version does, and stored
// K-major, so the inner loop reads float4s of A and of B into a TM x 4
// register tile.  Where the M x N tiles leave the card short of CTAs (most
// blocks below 28x28), K is split over the grid's z; the splits' partials
// go to a scratch tensor and the split-K kernel sums them in split order,
// with no atomics, so results repeat bit for bit.  Tile and split count
// come from core.autotune.retain_plan.
//
// Recompute (B2) keeps its first design: one 32-channel tile per lane, a
// 64-pixel tile cap, the expand read as float4 broadcasts from global
// memory.
//
// SiLU and sigmoid use __expf and __fdividef (a few ulp), in every kernel
// of this file.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

constexpr int CT = 32;                  // channel tile: one lane per channel
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAXP = 64;                // output pixels per CTA tile
constexpr int PPW = MAXP / NWARPS;      // output pixels per warp

// pass 1
constexpr int P1_CI = 16;               // C_in chunk staged per ring slot
constexpr int P1_MAXP = 128;            // output pixels per CTA tile
constexpr int P1_PAD = 4;               // padding floats per staged pixel
constexpr int P1_NT = 256;              // threads per CTA
constexpr int P1_RUN = 4;               // DW output pixels per thread run
constexpr int P1_SLOTS = 3;             // cp.async ring depth over C_in
constexpr int P1_TP = 4;                // expand pixels per register block
constexpr int P1_MAX_NB = 4;            // register blocks per thread and pass

// retain
constexpr int R_BK = 32;                // K chunk
constexpr int R_STAGES = 3;             // cp.async ring depth

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

__device__ __forceinline__ void fma4(float (&acc)[4], float a, const float4& b) {
  acc[0] = fmaf(a, b.x, acc[0]);
  acc[1] = fmaf(a, b.y, acc[1]);
  acc[2] = fmaf(a, b.z, acc[2]);
  acc[3] = fmaf(a, b.w, acc[3]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c, float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// ---------------------------------------------------------------------------
// recompute (B2): its own helpers, unchanged from the first design
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// pass 1 (B1)
// ---------------------------------------------------------------------------

// c_mid channels one pass-1 CTA owns: 64, or 32 where 64-wide tiles would
// pad C_mid by more than an eighth.
__host__ __device__ constexpr int p1_cm_tile(int C_mid) {
  return C_mid >= 64 && ((C_mid + 63) / 64 * 64 - C_mid) * 8 <= C_mid ? 64 : 32;
}

// Register blocks per pass-1 thread: the fewest of 1, 2 and P1_MAX_NB
// covering a Q-pixel window in one pass (P1_MAX_NB past that).
__host__ __device__ inline int p1_blocks_per_thread(int Q, int CMT) {
  const int lanes = P1_NT / (CMT / 4);              // pixel lanes
  const int per = ((Q + P1_TP - 1) / P1_TP + lanes - 1) / lanes;
  return per <= 1 ? 1 : per <= 2 ? 2 : P1_MAX_NB;
}

// x / w_exp ring slots of pass 1: P1_SLOTS, fewer where C_in has fewer
// chunks.
__host__ __device__ inline int p1_slots(int C_in) {
  const int chunks = (C_in + P1_CI - 1) / P1_CI;
  return chunks < P1_SLOTS ? chunks : P1_SLOTS;
}

// Shared-memory floats of one pass-1 CTA, the window rounded up to whole
// P1_TP-pixel blocks: the expanded window, then one region that holds the
// staged x and w_exp chunks during the expand and the DW tile and pool rows
// after it (identity stages nothing).  core.autotune.pass1_smem_bytes
// mirrors this.
__host__ __device__ inline size_t p1_smem_floats(int Q, int P, int CMT, int C_in,
                                                 int identity) {
  const size_t qp = (size_t)((Q + P1_TP - 1) / P1_TP) * P1_TP;
  const size_t stage =
      identity ? 0 : p1_slots(C_in) * (qp * (P1_CI + P1_PAD) + (size_t)P1_CI * CMT);
  const size_t after = (size_t)P * (CMT + P1_PAD) + (size_t)(P1_NT / (CMT / 4)) * CMT;
  return qp * (CMT + P1_PAD) + (stage > after ? stage : after);
}

// grid (n_tiles, ceil(C_mid / CMT), B).  pool_partial (B, n_tiles, C_mid)
// or null (se off); dw_out (B, out_h, out_w, C_mid) or null (recompute).
template <int K, int S, int CMT, int NB>
__global__ void __launch_bounds__(P1_NT)
mbconv_pass1_kernel(const float* __restrict__ x, const float* __restrict__ w_exp,
                    const float* __restrict__ w_dw, float* __restrict__ pool_partial,
                    float* __restrict__ dw_out, Geom g, int identity, int exp_act,
                    int dw_act) {
  constexpr int EP = CMT + P1_PAD;      // floats per expanded / DW pixel
  constexpr int XP = P1_CI + P1_PAD;    // floats per staged input pixel
  constexpr int CG = CMT / 4;           // float4 channel groups
  constexpr int NG = P1_NT / CG;        // pixel lanes of the expand and pool
  constexpr int NGD = P1_NT / CMT;      // pixel lanes of the DW taps
  constexpr int SEG = (P1_RUN - 1) * S + K;

  extern __shared__ float4 smem4[];
  const int Q = g.in_rows * g.in_cols, QP = (Q + P1_TP - 1) / P1_TP * P1_TP;
  const int P = g.tile_h * g.tile_w;
  const int slots = p1_slots(g.C_in);
  float* e_s = reinterpret_cast<float*>(smem4);    // QP x EP
  float* x_s = e_s + (size_t)QP * EP;              // slots x QP x XP, then
  float* w_s = x_s + (size_t)slots * QP * XP;      // slots x P1_CI x CMT
  float* d_s = x_s;                                // P x EP after the expand
  float* r_s = d_s + (size_t)P * EP;               // NG x CMT

  const int tile = blockIdx.x, cm0 = blockIdx.y * CMT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int tid = threadIdx.x;
  const bool vec_mid = (g.C_mid & 3) == 0;

  // ---- expand + exp_act over the window, into e_s ----
  if (identity) {
    // C_in == C_mid (a multiple of 4): the window's channel tile straight
    // into e_s by 16-byte copies, then exp_act in place
    for (int i = tid; i < Q * CG; i += P1_NT) {
      const int q = i / CG, j = i % CG;
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const int cm = cm0 + 4 * j;
      const bool ok = cm < g.C_mid && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      cp_async16(e_s + q * EP + 4 * j,
                 ok ? x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + cm : x,
                 ok ? 16 : 0);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (exp_act != ACT_NONE)
      for (int i = tid; i < Q * CMT; i += P1_NT) {
        float* e = e_s + (i / CMT) * EP + i % CMT;
        *e = act_apply(*e, exp_act);
      }
  } else {
    auto stage = [&](int chunk, int slot) {
      const int ci0 = chunk * P1_CI;
      float* xb = x_s + (size_t)slot * QP * XP;
      float* wb = w_s + slot * P1_CI * CMT;
      for (int i = tid; i < Q * (P1_CI / 4); i += P1_NT) {
        const int q = i / (P1_CI / 4), j = i % (P1_CI / 4);
        const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
        const int ci = ci0 + 4 * j;
        const bool ok = ci < g.C_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
        cp_async16(xb + q * XP + 4 * j,
                   ok ? x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci : x,
                   ok ? 16 : 0);
      }
      for (int i = tid; i < P1_CI * CG; i += P1_NT) {
        const int r = i / CG, j = i % CG;
        const int ci = ci0 + r, cm = cm0 + 4 * j;
        float* dst = wb + r * CMT + 4 * j;
        const float* row = w_exp + (size_t)ci * g.C_mid;
        if (vec_mid) {
          const int n = ci < g.C_in ? max(0, min(4, g.C_mid - cm)) : 0;
          cp_async16(dst, n ? row + cm : w_exp, 4 * n);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool ok = ci < g.C_in && cm + u < g.C_mid;
            cp_async4(dst + u, ok ? row + cm + u : w_exp, ok ? 4 : 0);
          }
        }
      }
    };

    // Thread (tc, tp) owns channels tc * 4 .. + 3 and pixel blocks tp,
    // tp + NG, ... (NB of them per pass), its NB x 4 x 4 sums in registers
    // across all of C_in.  Windows of more than NB * NG blocks take several
    // passes, each streaming C_in again.  Ring of P1_SLOTS: chunk c + 2 is
    // staged into the slot chunk c - 1 used, once the barrier shows every
    // thread done with it, so one barrier per chunk.
    const int n_chunks = (g.C_in + P1_CI - 1) / P1_CI;
    const int tc = tid % CG, tp = tid / CG;
    const int n_blocks = (Q + P1_TP - 1) / P1_TP;
    for (int pass0 = 0; pass0 < n_blocks; pass0 += NB * NG) {
      float acc[NB][P1_TP][4];
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < P1_TP; ++i)
          acc[nb][i][0] = acc[nb][i][1] = acc[nb][i][2] = acc[nb][i][3] = 0.f;
      if (pass0 > 0) __syncthreads();       // the last pass is done with the ring
#pragma unroll
      for (int c = 0; c < P1_SLOTS - 1; ++c) {
        if (c < n_chunks) stage(c, c);
        cp_async_commit();
      }
      for (int c = 0; c < n_chunks; ++c) {
        cp_async_wait<P1_SLOTS - 2>();
        __syncthreads();
        if (c + P1_SLOTS - 1 < n_chunks) stage(c + P1_SLOTS - 1, (c + P1_SLOTS - 1) % slots);
        cp_async_commit();
        const float* xb = x_s + (size_t)(c % slots) * QP * XP;
        const float* wb = w_s + (c % slots) * P1_CI * CMT + tc * 4;
        // chunk rows past C_in were zero-filled on both sides: they add 0
#pragma unroll
        for (int kk = 0; kk < P1_CI; kk += 4) {
          float4 w[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = ld4(wb + (kk + u) * CMT);
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
            const int q0 = (pass0 + tp + nb * NG) * P1_TP;
            if (q0 >= Q) continue;
            float4 xv[P1_TP];
#pragma unroll
            for (int i = 0; i < P1_TP; ++i) xv[i] = ld4(xb + (q0 + i) * XP + kk);
#pragma unroll
            for (int i = 0; i < P1_TP; ++i) {
              fma4(acc[nb][i], xv[i].x, w[0]);
              fma4(acc[nb][i], xv[i].y, w[1]);
              fma4(acc[nb][i], xv[i].z, w[2]);
              fma4(acc[nb][i], xv[i].w, w[3]);
            }
          }
        }
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int q0 = (pass0 + tp + nb * NG) * P1_TP;
        if (q0 >= Q) continue;
#pragma unroll
        for (int i = 0; i < P1_TP; ++i) {
#pragma unroll
          for (int u = 0; u < 4; ++u) acc[nb][i][u] = act_apply(acc[nb][i][u], exp_act);
          st4(e_s + (q0 + i) * EP + tc * 4, acc[nb][i][0], acc[nb][i][1], acc[nb][i][2],
              acc[nb][i][3]);
        }
      }
    }
  }
  __syncthreads();

  // ---- depthwise taps + dw_act, into d_s (0 at masked pixels/channels) ----
  {
    const int cmi = tid % CMT, grp = tid / CMT, cm = cm0 + cmi;
    const bool cm_ok = cm < g.C_mid;
    float wd[K * K];
    load_dw_taps<K>(w_dw, wd, g.C_mid, cm);
    const int n_run = (g.tile_w + P1_RUN - 1) / P1_RUN;
    for (int it = grp; it < g.tile_h * n_run; it += NGD) {
      const int pr = it / n_run, pc0 = (it % n_run) * P1_RUN;
      float acc[P1_RUN];
#pragma unroll
      for (int r = 0; r < P1_RUN; ++r) acc[r] = 0.f;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float* row = e_s + (size_t)(pr * S + j) * g.in_cols * EP + cmi;
        float seg[SEG];
#pragma unroll
        for (int i = 0; i < SEG; ++i) {
          const int col = pc0 * S + i;
          seg[i] = col < g.in_cols ? row[col * EP] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < P1_RUN; ++r)
#pragma unroll
          for (int i = 0; i < K; ++i) acc[r] = fmaf(seg[r * S + i], wd[j * K + i], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < P1_RUN; ++r) {
        const int pc = pc0 + r;
        if (pc >= g.tile_w) break;
        const bool ok = cm_ok && oh0 + pr < g.out_h && ow0 + pc < g.out_w;
        d_s[(pr * g.tile_w + pc) * EP + cmi] = ok ? act_apply(acc[r], dw_act) : 0.f;
      }
    }
  }
  __syncthreads();

  // ---- SE pool partial of this tile: column sums of d_s ----
  const int cg = tid % CG, pl = tid / CG;
  if (pool_partial) {
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int p = pl; p < P; p += NG) {
      const float4 d = ld4(d_s + p * EP + cg * 4);
      s[0] += d.x; s[1] += d.y; s[2] += d.z; s[3] += d.w;
    }
    st4(r_s + pl * CMT + cg * 4, s[0], s[1], s[2], s[3]);
    __syncthreads();
    if (tid < CMT && cm0 + tid < g.C_mid) {
      float t = 0.f;
#pragma unroll
      for (int l = 0; l < NG; ++l) t += r_s[l * CMT + tid];
      pool_partial[((size_t)b * gridDim.x + tile) * g.C_mid + cm0 + tid] = t;
    }
  }

  // ---- the retained DW tile, float4 along C_mid ----
  if (dw_out) {
    for (int i = tid; i < P * CG; i += P1_NT) {
      const int p = i / CG, j = i % CG;
      const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
      const int cm = cm0 + 4 * j;
      if (oh >= g.out_h || ow >= g.out_w || cm >= g.C_mid) continue;
      float* dst = dw_out + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_mid + cm;
      const float4 d = ld4(d_s + p * EP + 4 * j);
      if (vec_mid) {
        *reinterpret_cast<float4*>(dst) = d;
      } else {
        const float v[4] = {d.x, d.y, d.z, d.w};
        for (int u = 0; u < 4 && cm + u < g.C_mid; ++u) dst[u] = v[u];
      }
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

// ---------------------------------------------------------------------------
// retain (B3): a split-K fp32 GEMM with the SE gate folded into A
// ---------------------------------------------------------------------------

// A BM x BN CTA tile, TM x 4 outputs per thread.
template <int BM, int BN, int TM>
struct RetainTile {
  static constexpr int NT = (BM / TM) * (BN / 4);    // threads per CTA
  static constexpr int AP = R_BK + 4;                // floats per staged A row
  static constexpr size_t SMEM =
      (R_STAGES * (size_t)BM * AP + R_STAGES * (size_t)R_BK * BN + 2 * (size_t)R_BK * BM) *
      sizeof(float);
};

// grid (ceil(N / BN), ceil(M / BM), splits).  A = dw (M, K), gate (B, K) or
// null (se off), W = w_proj (K, N); split z sums K chunks
// [z * chunks_per_split, (z + 1) * chunks_per_split) into C + z * M * N.
// VEC: K and N are multiples of 4 (16-byte copies and stores).
template <int BM, int BN, int TM, bool VEC>
__global__ void __launch_bounds__(RetainTile<BM, BN, TM>::NT)
mbconv_pass2_retain_kernel(const float* __restrict__ A, const float* __restrict__ gate,
                           const float* __restrict__ W, float* __restrict__ C, int M,
                           int K, int N, int rows_per_img, int chunks_per_split) {
  using T = RetainTile<BM, BN, TM>;
  constexpr int NT = T::NT, AP = T::AP, ST = R_STAGES;
  extern __shared__ float4 smem4[];
  float* a_raw = reinterpret_cast<float*>(smem4);      // ST x BM x AP
  float* b_s = a_raw + ST * BM * AP;                   // ST x R_BK x BN
  float* a_t = b_s + ST * R_BK * BN;                   // 2 x R_BK x BM (K-major)

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_chunks = (K + R_BK - 1) / R_BK;
  const int c0 = blockIdx.z * chunks_per_split;
  const int n_loc = max(0, min(n_chunks, c0 + chunks_per_split) - c0);

  auto stage = [&](int t, int slot) {
    const int k0 = (c0 + t) * R_BK;
    float* ab = a_raw + slot * BM * AP;
    float* bb = b_s + slot * R_BK * BN;
    if (VEC) {
      for (int i = tid; i < BM * (R_BK / 4); i += NT) {
        const int m = i / (R_BK / 4), j = i % (R_BK / 4);
        const int gm = m0 + m, k = k0 + 4 * j;
        const bool ok = gm < M && k < K;
        cp_async16(ab + m * AP + 4 * j, ok ? A + (size_t)gm * K + k : A, ok ? 16 : 0);
      }
      for (int i = tid; i < R_BK * (BN / 4); i += NT) {
        const int r = i / (BN / 4), j = i % (BN / 4);
        const int k = k0 + r, n = n0 + 4 * j;
        const bool ok = k < K && n < N;
        cp_async16(bb + r * BN + 4 * j, ok ? W + (size_t)k * N + n : W, ok ? 16 : 0);
      }
    } else {
      for (int i = tid; i < BM * R_BK; i += NT) {
        const int m = i / R_BK, kk = i % R_BK;
        const int gm = m0 + m, k = k0 + kk;
        const bool ok = gm < M && k < K;
        cp_async4(ab + m * AP + kk, ok ? A + (size_t)gm * K + k : A, ok ? 4 : 0);
      }
      for (int i = tid; i < R_BK * BN; i += NT) {
        const int r = i / BN, nn = i % BN;
        const int k = k0 + r, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp_async4(bb + r * BN + nn, ok ? W + (size_t)k * N + n : W, ok ? 4 : 0);
      }
    }
  };

  // Each thread transposes ITEMS float4s of every A chunk: item it is row
  // m = i % BM, k group j = i / BM of chunk i = tid + it * NT.  Its gate
  // values are loaded into registers one chunk ahead, so no global load
  // waits inside the loop.
  constexpr int ITEMS = BM * (R_BK / 4) / NT;
  static_assert(ITEMS * NT == BM * (R_BK / 4), "threads must tile the A chunk");
  float g_next[ITEMS][4];
  auto load_gate = [&](int t) {
    const int k0 = (c0 + t) * R_BK;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * NT, m = i % BM, j = i / BM, gm = m0 + m;
      const float* gr = gate + (size_t)(gm / rows_per_img) * K + k0 + 4 * j;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        g_next[it][u] = gm < M && k0 + 4 * j + u < K ? __ldg(gr + u) : 0.f;
    }
  };

  // A chunk t: x gate of the row's image (rounded before the product, as
  // the plain version's d * gate), transposed to K-major.
  auto transpose_gate = [&](int slot, float* at) {
    const float* ab = a_raw + slot * BM * AP;
#pragma unroll
    for (int it = 0; it < ITEMS; ++it) {
      const int i = tid + it * NT, m = i % BM, j = i / BM;
      const float4 v = ld4(ab + m * AP + 4 * j);
      float e[4] = {v.x, v.y, v.z, v.w};
      if (gate) {
#pragma unroll
        for (int u = 0; u < 4; ++u) e[u] *= g_next[it][u];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) at[(4 * j + u) * BM + m] = e[u];
    }
  };

  const int tx = tid % (BN / 4), ty = tid / (BN / 4);
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_loc) stage(s, s);
    cp_async_commit();
  }
  if (gate && n_loc > 0) load_gate(0);
  for (int t = 0; t < n_loc; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();
    float* at = a_t + (t & 1) * R_BK * BM;
    transpose_gate(t % ST, at);
    if (gate && t + 1 < n_loc) load_gate(t + 1);
    if (t + ST - 1 < n_loc) stage(t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    __syncthreads();
    const float* bb = b_s + (t % ST) * R_BK * BN + tx * 4;
    const float* ar = at + ty * TM;
#pragma unroll
    for (int kk = 0; kk < R_BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 v = ld4(ar + kk * BM + i);
        a[i] = v.x; a[i + 1] = v.y; a[i + 2] = v.z; a[i + 3] = v.w;
      }
      const float4 w = ld4(bb + kk * BN);
#pragma unroll
      for (int i = 0; i < TM; ++i) fma4(acc[i], a[i], w);
    }
  }

  float* out = C + (size_t)blockIdx.z * M * N;
  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M || n >= N) continue;
    float* dst = out + (size_t)m * N + n;
    if (VEC) {
      st4(dst, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    } else {
      for (int u = 0; u < 4 && n + u < N; ++u) dst[u] = acc[i][u];
    }
  }
}

// out[i] = ((p[0][i] + p[1][i]) + p[2][i]) + ...: the splits in order.
template <bool VEC>
__global__ void mbconv_splitk_reduce_kernel(const float* __restrict__ partial,
                                            float* __restrict__ out, int splits,
                                            long long count) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (VEC) {
    const long long n4 = count / 4;
    const float4* p = reinterpret_cast<const float4*>(partial);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
      float4 s = p[i];
      for (int z = 1; z < splits; ++z) {
        const float4 v = p[(size_t)z * n4 + i];
        s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
      }
      reinterpret_cast<float4*>(out)[i] = s;
    }
  } else {
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
      float s = partial[i];
      for (int z = 1; z < splits; ++z) s += partial[(size_t)z * count + i];
      out[i] = s;
    }
  }
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

bool geom_ok(const Geom& g, int max_pixels) {
  return g.B > 0 && g.C_in > 0 && g.C_mid > 0 && g.C_out > 0 && g.out_h > 0 &&
         g.out_w > 0 && g.tile_h > 0 && g.tile_w > 0 &&
         g.tile_h * g.tile_w <= max_pixels && g.C_in % 4 == 0 && g.B <= 65535;
}

constexpr size_t MAX_SMEM = 232448;     // 227 KB: the per-CTA opt-in maximum

// Raises a kernel's dynamic shared-memory cap to the card's maximum.  The
// launchers call it once per kernel instance (a function-local static), so
// no attribute call lands inside a CUDA graph capture.
template <typename Kern>
cudaError_t set_max_smem(Kern kern) {
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
}

size_t pass1_smem(const Geom& g, int identity) {
  return p1_smem_floats(g.in_rows * g.in_cols, g.tile_h * g.tile_w, p1_cm_tile(g.C_mid),
                        g.C_in, identity) *
         sizeof(float);
}

template <int K, int S, int CMT, int NB>
cudaError_t launch_pass1_nb(const float* x, const float* w_exp, const float* w_dw,
                            float* pool_partial, float* dw_out, const Geom& g,
                            int identity, int exp_act, int dw_act, cudaStream_t stream) {
  const size_t smem = pass1_smem(g, identity);
  static const cudaError_t smem_set = set_max_smem(mbconv_pass1_kernel<K, S, CMT, NB>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_mid + CMT - 1) / CMT, g.B);
  mbconv_pass1_kernel<K, S, CMT, NB><<<grid, P1_NT, smem, stream>>>(
      x, w_exp, w_dw, pool_partial, dw_out, g, identity, exp_act, dw_act);
  return cudaGetLastError();
}

// NB, the pixel blocks a thread holds per pass: the fewest of 1, 2 and
// P1_MAX_NB that cover the window in one pass (else P1_MAX_NB, in passes).
template <int K, int S, int CMT>
cudaError_t launch_pass1_cm(const float* x, const float* w_exp, const float* w_dw,
                            float* pool_partial, float* dw_out, const Geom& g,
                            int identity, int exp_act, int dw_act, cudaStream_t stream) {
  const int nb = p1_blocks_per_thread(g.in_rows * g.in_cols, CMT);
  if (nb == 1)
    return launch_pass1_nb<K, S, CMT, 1>(x, w_exp, w_dw, pool_partial, dw_out, g, identity,
                                         exp_act, dw_act, stream);
  if (nb == 2)
    return launch_pass1_nb<K, S, CMT, 2>(x, w_exp, w_dw, pool_partial, dw_out, g, identity,
                                         exp_act, dw_act, stream);
  return launch_pass1_nb<K, S, CMT, P1_MAX_NB>(x, w_exp, w_dw, pool_partial, dw_out, g,
                                               identity, exp_act, dw_act, stream);
}

template <int K, int S>
cudaError_t launch_pass1(const float* x, const float* w_exp, const float* w_dw,
                         float* pool_partial, float* dw_out, const Geom& g,
                         int identity, int exp_act, int dw_act, cudaStream_t stream) {
  if (p1_cm_tile(g.C_mid) == 64)
    return launch_pass1_cm<K, S, 64>(x, w_exp, w_dw, pool_partial, dw_out, g, identity,
                                     exp_act, dw_act, stream);
  return launch_pass1_cm<K, S, 32>(x, w_exp, w_dw, pool_partial, dw_out, g, identity,
                                   exp_act, dw_act, stream);
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

template <int BM, int BN, int TM, bool VEC>
cudaError_t launch_retain_tile(const float* dw, const float* gate, const float* w_proj,
                               float* out, int M, int K, int N, int rows_per_img,
                               int splits, int chunks_per_split, cudaStream_t stream) {
  using T = RetainTile<BM, BN, TM>;
  static const cudaError_t smem_set =
      set_max_smem(mbconv_pass2_retain_kernel<BM, BN, TM, VEC>);
  if (smem_set != cudaSuccess) return smem_set;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  mbconv_pass2_retain_kernel<BM, BN, TM, VEC><<<grid, T::NT, T::SMEM, stream>>>(
      dw, gate, w_proj, out, M, K, N, rows_per_img, chunks_per_split);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_retain(int bm, int bn, const float* dw, const float* gate,
                          const float* w_proj, float* out, int M, int K, int N,
                          int rows_per_img, int splits, int cps, cudaStream_t stream) {
#define RETAIN_TILE(BM_, BN_, TM_)                                                   \
  if (bm == BM_ && bn == BN_)                                                        \
    return launch_retain_tile<BM_, BN_, TM_, VEC>(dw, gate, w_proj, out, M, K, N,     \
                                                  rows_per_img, splits, cps, stream);
  RETAIN_TILE(128, 64, 8)
  RETAIN_TILE(64, 64, 4)
  RETAIN_TILE(128, 32, 4)
  RETAIN_TILE(64, 32, 4)
#undef RETAIN_TILE
  return cudaErrorInvalidValue;
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
int mbconv_pass1_ci_chunk() { return P1_CI; }
int mbconv_pass1_max_tile_pixels() { return P1_MAXP; }
int mbconv_pass1_cm_tile(int C_mid) { return p1_cm_tile(C_mid); }
long long mbconv_pass1_smem_bytes(int K, int S, int tile_h, int tile_w, int C_in,
                                  int C_mid, int identity) {
  const int q = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  return (long long)(p1_smem_floats(q, tile_h * tile_w, p1_cm_tile(C_mid), C_in, identity) *
                     sizeof(float));
}
int mbconv_retain_k_chunk() { return R_BK; }
const char* mbconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int mbconv_pass1(const float* x, const float* w_exp, const float* w_dw,
                 float* pool_partial, float* dw_out, int B, int H, int W, int C_in,
                 int C_mid, int K, int S, int out_h, int out_w, int pad_top,
                 int pad_left, int tile_h, int tile_w, int identity, int exp_act,
                 int dw_act, void* stream) {
  const Geom g = make_geom(B, H, W, C_in, C_mid, 1, K, S, out_h, out_w, pad_top,
                           pad_left, tile_h, tile_w);
  if (!geom_ok(g, P1_MAXP)) return (int)cudaErrorInvalidValue;
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
  if (!geom_ok(g, MAXP)) return (int)cudaErrorInvalidValue;
  MBCONV_KS_SWITCH(K, S, launch_recompute<KK, SS>(x, w_exp, w_dw, gate, w_proj, out, g,
                                                  identity, exp_act, dw_act,
                                                  (cudaStream_t)stream))
}

// dw (M, K) rows of rows_per_img pixels per image; out (splits, M, N): the
// output itself for splits == 1, else the per-split partials.
int mbconv_pass2_retain(const float* dw, const float* gate, const float* w_proj,
                        float* out, int M, int K, int N, int rows_per_img, int bm,
                        int bn, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || rows_per_img <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (K + R_BK - 1) / R_BK;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((splits - 1) * cps >= n_chunks) return (int)cudaErrorInvalidValue;  // empty split
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      (K % 4 == 0 && N % 4 == 0)
          ? launch_retain<true>(bm, bn, dw, gate, w_proj, out, M, K, N, rows_per_img,
                                splits, cps, s)
          : launch_retain<false>(bm, bn, dw, gate, w_proj, out, M, K, N, rows_per_img,
                                 splits, cps, s);
  return (int)err;
}

// partial (splits, count) -> out (count), summed in split order.
int mbconv_splitk_reduce(const float* partial, float* out, int splits, long long count,
                         void* stream) {
  if (splits <= 0 || count <= 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const bool vec = count % 4 == 0;
  const long long items = vec ? count / 4 : count;
  const int blocks = (int)std::min<long long>((items + threads - 1) / threads, 132 * 16);
  if (vec)
    mbconv_splitk_reduce_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        partial, out, splits, count);
  else
    mbconv_splitk_reduce_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        partial, out, splits, count);
  return (int)cudaGetLastError();
}

}  // extern "C"
