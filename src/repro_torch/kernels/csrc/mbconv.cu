// Two-pass fused MBConv kernels for Hopper (sm_90a), fp32 on CUDA cores.
//
// Replaces the three Pallas TPU kernels of the JAX package's MBConv path
// (src/repro/kernels/convdk_mbconv.py):
//
//   mbconv_pass1_kernel            <- _mbconv_pass1_kernel            (:118),
//                                     its cross-strip SE pool sum
//                                     (:151-163) folded into the epilogue
//   mbconv_pass2_recompute_kernel  <- _mbconv_pass2_recompute_kernel  (:169)
//   mbconv_pass2_retain_kernel     <- _mbconv_pass2_retain_kernel     (:220)
//   mbconv_splitk_reduce_kernel    <- the c_mid accumulation across grid
//                                     steps of _mbconv_pass2_retain_kernel
//                                     (:245-251) and of the recompute one
//
// What they compute (NHWC activations, w_exp (C_in, C_mid), w_dw
// (k, k, C_mid), w_proj (C_mid, C_out), all fp32):
//
//   pass 1     expand 1x1 (reduce C_in) -> exp_act -> k x k / s depthwise
//              -> dw_act; per-tile SE pool partial sums and their sum, the
//              pool (B, C_mid), and under retain the DW tensor
//              (B, out_h, out_w, C_mid).
//   recompute  expand + DW again, x SE gate, projection 1x1 (reduce C_mid).
//   retain     re-read the DW tensor, x SE gate, projection 1x1.
//   split-K    sums retain's or recompute's per-split partial products in
//              split order.
//
// The Pallas grids reduce over *sequential* grid steps (c_in innermost,
// c_mid for the projection, strips for the pool); CTAs have no order, so a
// reduction either loops inside one CTA, or goes through partials summed in
// a fixed order by a second kernel or by the CTA that finishes last (an
// arrival counter elects it; no value is ever added atomically), so results
// repeat bit for bit.  SAME padding is a bounds mask everywhere: an input
// pixel outside the image reads as 0, so its expanded value is exp_act(0),
// exactly what the JAX kernel's zero-padded input gives.  Ragged pixels,
// channels and rows are masked in the kernels; the wrappers pad nothing.
// fp32 FMA on CUDA cores, no tensor cores: a 1xTF32 product misses the JAX
// suite's 1e-4 fp32 bar.
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
// The SE pool (B1') is pass 1's tail, a threadfence reduction: each CTA
// writes its column-sum partial and counts itself in at its (b, c_mid
// tile)'s arrival counter with an acquire-release atomic; the CTA that
// arrives last stages that pair's n_tiles partials through shared memory
// with all its threads (L2 loads, never the read-only path), sums them in
// tile order, writes the pool and resets the counter to 0, so the buffer is
// ready for the next launch and for CUDA graph replays.  The counter only
// elects the summing CTA; the order of the sum is fixed.  The counters are
// one persistent zeroed buffer per device, which assumes one stream at a
// time runs pass 1 on it, as the port does.
//
// Recompute (B2; bound by operations: the expand over the halo'd window,
// as pass 1, then the projection).  One CTA owns a tile_h x tile_w output
// tile (up to R2_MAXP pixels), a c_out tile (16, 32, 64 or 128 channels:
// all of C_out up to 128, so the expand runs once per pixel tile, and at
// most 3 times at C_out 320) and a range of c_mid chunks.  Per chunk of
// pass 1's c_mid tile it runs pass 1's expand and depthwise (the same
// cp.async ring and register-blocked GEMM), multiplies the DW tile by the
// SE gate (rounded before the product, as the plain version's d * gate)
// into shared memory, and adds its projection into a register tile of
// R2_TM_SMALL (where that covers the tile: c_out tiles up to 32) or R2_TM
// pixels x 4 channels per thread, kept in shared memory between chunks (so
// the expand runs with about pass 1's registers); the chunk's w_proj
// rows stream R2_KC at a time through a cp.async ring whose first slots
// load while the DW taps run.  Where the
// pixel tiles leave the card short of CTAs, C_mid is split over the grid
// (core.autotune.recompute_plan); the splits' partials go to a scratch
// tensor and the split-K kernel sums them in split order.
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
// SiLU and sigmoid use __expf and __fdividef (a few ulp), in every kernel
// of this file.

#include <cuda_runtime.h>
#include <stddef.h>

#include <algorithm>

namespace {

// pass 1
constexpr int P1_CI = 16;               // C_in chunk staged per ring slot
constexpr int P1_MAXP = 128;            // output pixels per CTA tile
constexpr int P1_PAD = 4;               // padding floats per staged pixel
constexpr int P1_NT = 256;              // threads per CTA
constexpr int P1_RUN = 4;               // DW output pixels per thread run
constexpr int P1_SLOTS = 3;             // cp.async ring depth over C_in
constexpr int P1_TP = 4;                // expand pixels per register block
constexpr int P1_MAX_NB = 4;            // register blocks per thread and pass

// recompute
constexpr int R2_MAXP = 64;             // output pixels per CTA tile
constexpr int R2_KC = 16;               // w_proj rows per ring slot
constexpr int R2_TM = 8;                // projection pixels per thread, at most
constexpr int R2_TM_SMALL = 2;          // ... at the c_out tiles that need at most 2

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

// atomicAdd with acquire-release semantics at device scope.
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
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
// pass 1 (B1), whose expand and depthwise B2 shares
// ---------------------------------------------------------------------------

// c_mid channels one pass-1 CTA owns (and one B2 chunk): 64, or 32 where
// 64-wide tiles would pad C_mid by more than an eighth.
__host__ __device__ constexpr int p1_cm_tile(int C_mid) {
  return C_mid >= 64 && ((C_mid + 63) / 64 * 64 - C_mid) * 8 <= C_mid ? 64 : 32;
}

// Register blocks per expanding thread: the fewest of 1, 2 and P1_MAX_NB
// covering a Q-pixel window in one pass (P1_MAX_NB past that).
__host__ __device__ inline int p1_blocks_per_thread(int Q, int CMT) {
  const int lanes = P1_NT / (CMT / 4);              // pixel lanes
  const int per = ((Q + P1_TP - 1) / P1_TP + lanes - 1) / lanes;
  return per <= 1 ? 1 : per <= 2 ? 2 : P1_MAX_NB;
}

// x / w_exp ring slots of the expand: P1_SLOTS, fewer where C_in has fewer
// chunks.
__host__ __device__ inline int p1_slots(int C_in) {
  const int chunks = (C_in + P1_CI - 1) / P1_CI;
  return chunks < P1_SLOTS ? chunks : P1_SLOTS;
}

// Shared-memory floats of the expand, the window rounded up to whole
// P1_TP-pixel blocks: the expanded window, then the staging ring (none for
// an identity expand), which the callers' later stages reuse.
__host__ __device__ inline size_t p1_window_floats(int Q, int CMT) {
  return (size_t)((Q + P1_TP - 1) / P1_TP) * P1_TP * (CMT + P1_PAD);
}

__host__ __device__ inline size_t p1_stage_floats(int Q, int CMT, int C_in, int identity) {
  const size_t qp = (size_t)((Q + P1_TP - 1) / P1_TP) * P1_TP;
  return identity ? 0 : p1_slots(C_in) * (qp * (P1_CI + P1_PAD) + (size_t)P1_CI * CMT);
}

// One pass-1 CTA: the window, then one region holding the staging ring
// during the expand and the DW tile and pool rows after it.
// core.autotune.pass1_smem_bytes mirrors this.
__host__ __device__ inline size_t p1_smem_floats(int Q, int P, int CMT, int C_in,
                                                 int identity) {
  const size_t stage = p1_stage_floats(Q, CMT, C_in, identity);
  const size_t after = (size_t)P * (CMT + P1_PAD) + (size_t)(P1_NT / (CMT / 4)) * CMT;
  return p1_window_floats(Q, CMT) + (stage > after ? stage : after);
}

template <int K>
__device__ __forceinline__ void load_dw_taps(const float* __restrict__ w_dw,
                                             float (&wd)[K * K], int C_mid,
                                             int cm) {
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wd[t] = cm < C_mid ? __ldg(w_dw + (size_t)t * C_mid + cm) : 0.f;
}

// Expand 1x1 + exp_act of the halo'd window at (ih0, iw0), c_mid channels
// [cm0, cm0 + CMT), into e_s (QP x (CMT + P1_PAD)), staging through x_s and
// w_s.  The caller's barrier publishes e_s.
template <int CMT, int NB>
__device__ __forceinline__ void p1_expand(const float* __restrict__ x,
                                          const float* __restrict__ w_exp, float* e_s,
                                          float* x_s, float* w_s, const Geom& g, int b,
                                          int ih0, int iw0, int cm0, int identity,
                                          int exp_act) {
  constexpr int EP = CMT + P1_PAD;      // floats per expanded pixel
  constexpr int XP = P1_CI + P1_PAD;    // floats per staged input pixel
  constexpr int CG = CMT / 4;           // float4 channel groups
  constexpr int NG = P1_NT / CG;        // pixel lanes
  const int Q = g.in_rows * g.in_cols, QP = (Q + P1_TP - 1) / P1_TP * P1_TP;
  const int slots = p1_slots(g.C_in);
  const int tid = threadIdx.x;
  const bool vec_mid = (g.C_mid & 3) == 0;

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
    return;
  }
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

// Depthwise taps + dw_act out of the expanded window e_s, x gate[cm] where
// gate (the image's row) is not null, into d_s (tile pixels x
// (CMT + P1_PAD); 0 at masked pixels and channels).  The caller's barrier
// publishes d_s.
template <int K, int S, int CMT>
__device__ __forceinline__ void p1_depthwise(const float* e_s, const float* __restrict__ w_dw,
                                             const float* __restrict__ gate, float* d_s,
                                             const Geom& g, int cm0, int oh0, int ow0,
                                             int dw_act) {
  constexpr int EP = CMT + P1_PAD;
  constexpr int NGD = P1_NT / CMT;      // pixel lanes of the DW taps
  constexpr int SEG = (P1_RUN - 1) * S + K;
  const int tid = threadIdx.x;
  const int cmi = tid % CMT, grp = tid / CMT, cm = cm0 + cmi;
  const bool cm_ok = cm < g.C_mid;
  const float sc = gate && cm_ok ? __ldg(gate + cm) : 1.f;
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
      float v = ok ? act_apply(acc[r], dw_act) : 0.f;
      if (gate) v *= sc;
      d_s[(pr * g.tile_w + pc) * EP + cmi] = v;
    }
  }
}

// grid (n_tiles, ceil(C_mid / CMT), B).  pool_partial (B, n_tiles, C_mid),
// pool (B, C_mid) and counters (B x ceil(C_mid / CMT) ints, zero between
// launches), or all null (se off); dw_out (B, out_h, out_w, C_mid) or null
// (recompute).
template <int K, int S, int CMT, int NB>
__global__ void __launch_bounds__(P1_NT)
mbconv_pass1_kernel(const float* __restrict__ x, const float* __restrict__ w_exp,
                    const float* __restrict__ w_dw, float* __restrict__ pool_partial,
                    float* __restrict__ pool, int* __restrict__ counters,
                    float* __restrict__ dw_out, Geom g, int identity, int exp_act,
                    int dw_act) {
  constexpr int EP = CMT + P1_PAD;      // floats per expanded / DW pixel
  constexpr int XP = P1_CI + P1_PAD;    // floats per staged input pixel
  constexpr int CG = CMT / 4;           // float4 channel groups
  constexpr int NG = P1_NT / CG;        // pixel lanes of the pool

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

  p1_expand<CMT, NB>(x, w_exp, e_s, x_s, w_s, g, b, ih0, iw0, cm0, identity, exp_act);
  __syncthreads();
  p1_depthwise<K, S, CMT>(e_s, w_dw, nullptr, d_s, g, cm0, oh0, ow0, dw_act);
  __syncthreads();

  // ---- SE pool partial of this tile: column sums of d_s ----
  const int cg = tid % CG, pl = tid / CG;
  int* last = reinterpret_cast<int*>(r_s);
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
    // Threadfence reduction, as a grid barrier's arrival: after the CTA's
    // barrier one thread counts the CTA in with an acquire-release atomic
    // (its release publishes the CTA's partial, its acquire makes the
    // partials counted before it visible to the CTA that arrives last),
    // and the last resets the counter.  The other threads write the DW
    // tile meanwhile.  (A __threadfence() before a relaxed atomic, the
    // textbook form, was slower on the card: PERF.md.)
    __syncthreads();
    if (tid == 0) {
      int* ctr = counters + (size_t)b * gridDim.y + blockIdx.y;
      const bool done = atomic_add_acq_rel(ctr, 1) == (int)gridDim.x - 1;
      if (done) *ctr = 0;
      *last = done;
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

  // ---- the last CTA of the (b, c_mid tile): the pool, in tile order ----
  // Every thread stages rows of the n_tiles partials into e_s (L2 loads,
  // never the read-only path), then each channel's thread adds them in
  // tile order, so the pool is the plain version's sum bit for bit.
  if (pool_partial) {
    __syncthreads();
    if (!*last) return;
    const int n = gridDim.x, rows = QP * EP / CMT;
    const float* src = pool_partial + (size_t)b * n * g.C_mid + cm0;
    float t = 0.f;
    for (int r0 = 0; r0 < n; r0 += rows) {
      const int nr = min(rows, n - r0);
      if (r0 > 0) __syncthreads();        // the last batch is summed
      if (vec_mid) {
        for (int i = tid; i < nr * CG; i += P1_NT) {
          const int r = i / CG, j = i % CG;
          const float* q = src + (size_t)(r0 + r) * g.C_mid + 4 * j;
          reinterpret_cast<float4*>(e_s)[i] =
              cm0 + 4 * j < g.C_mid ? __ldcg(reinterpret_cast<const float4*>(q))
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      } else {
        for (int i = tid; i < nr * CMT; i += P1_NT) {
          const int r = i / CMT, c = i % CMT;
          e_s[i] = cm0 + c < g.C_mid ? __ldcg(src + (size_t)(r0 + r) * g.C_mid + c) : 0.f;
        }
      }
      __syncthreads();
      if (tid < CMT)
        for (int r = 0; r < nr; ++r) t += e_s[r * CMT + tid];
    }
    if (tid < CMT && cm0 + tid < g.C_mid) pool[(size_t)b * g.C_mid + cm0 + tid] = t;
  }
}

// ---------------------------------------------------------------------------
// recompute (B2): pass 1's expand + DW per c_mid chunk, gated, projected
// ---------------------------------------------------------------------------

// w_proj ring slots per chunk: P1_SLOTS, fewer where the chunk has fewer
// R2_KC-row steps.
__host__ __device__ constexpr int r2_slots(int CMT) {
  return CMT / R2_KC < P1_SLOTS ? CMT / R2_KC : P1_SLOTS;
}

// Projection pixels per thread at a c_out tile: P over the pixel lanes.
__host__ __device__ inline int r2_pixels_per_thread(int P, int co_tile) {
  const int lanes = P1_NT / (co_tile / 4);
  return (P + lanes - 1) / lanes;
}

// Shared-memory floats of one B2 CTA: the expanded window, then one region
// holding the staging ring during the expand and the gated DW tile and the
// w_proj ring after it, then the projection sums kept between c_mid chunks
// (a float4 per thread and pixel).  core.autotune.recompute_smem_bytes
// mirrors this.
__host__ __device__ inline size_t r2_smem_floats(int Q, int P, int CMT, int C_in, int identity,
                                                 int co_tile) {
  const size_t stage = p1_stage_floats(Q, CMT, C_in, identity);
  const size_t after =
      (size_t)P * (CMT + P1_PAD) + (size_t)r2_slots(CMT) * R2_KC * co_tile;
  return p1_window_floats(Q, CMT) + (stage > after ? stage : after) +
         (size_t)r2_pixels_per_thread(P, co_tile) * P1_NT * 4;
}

// grid (n_tiles, ceil(C_out / co_tile), splits * B), z = split * B + b;
// co_tile one of 16, 32, 64, 128.  gate (B, C_mid) or null (se off).  Split
// z sums c_mid chunks [z * chunks_per_split, (z + 1) * chunks_per_split)
// into out + z * B * out_h * out_w * C_out.  The projection sums live in
// registers only while a chunk is projected and in shared memory between
// chunks, so the expand runs with about pass 1's registers: three CTAs an
// SM at NB = 1, two above.  TM: R2_TM_SMALL or R2_TM, at least the
// projection pixels per thread.
template <int K, int S, int CMT, int NB, int TM>
__global__ void __launch_bounds__(P1_NT, NB == 1 ? 3 : 2)
mbconv_pass2_recompute_kernel(const float* __restrict__ x, const float* __restrict__ w_exp,
                              const float* __restrict__ w_dw, const float* __restrict__ gate,
                              const float* __restrict__ w_proj, float* __restrict__ out,
                              Geom g, int identity, int exp_act, int dw_act, int co_tile,
                              int chunks_per_split) {
  constexpr int EP = CMT + P1_PAD;
  constexpr int XP = P1_CI + P1_PAD;
  constexpr int STEPS = CMT / R2_KC;    // w_proj ring steps per chunk
  constexpr int WS = r2_slots(CMT);

  extern __shared__ float4 smem4[];
  const int Q = g.in_rows * g.in_cols, QP = (Q + P1_TP - 1) / P1_TP * P1_TP;
  const int P = g.tile_h * g.tile_w;
  float* e_s = reinterpret_cast<float*>(smem4);            // QP x EP
  float* x_s = e_s + (size_t)QP * EP;                      // the expand's ring,
  float* w_s = x_s + (size_t)p1_slots(g.C_in) * QP * XP;
  float* d_s = x_s;                                        // then P x EP
  float* p_s = d_s + (size_t)P * EP;                       // and WS x R2_KC x co_tile
  const size_t stage = p1_stage_floats(Q, CMT, g.C_in, identity);
  const size_t after = (size_t)P * EP + (size_t)WS * R2_KC * co_tile;
  float4* acc_s = reinterpret_cast<float4*>(x_s + (stage > after ? stage : after));

  const int tile = blockIdx.x, co0 = blockIdx.y * co_tile;
  const int b = blockIdx.z % g.B, split = blockIdx.z / g.B;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int tid = threadIdx.x;
  const int n_chunks = (g.C_mid + CMT - 1) / CMT;
  const int c0 = split * chunks_per_split;
  const int c1 = min(n_chunks, c0 + chunks_per_split);
  const float* gate_b = gate ? gate + (size_t)b * g.C_mid : nullptr;
  const bool vec_out = (g.C_out & 3) == 0;

  // The projection: thread (tx, ty) owns channels co0 + 4 tx .. + 3 of
  // pixels ty, ty + L, ... (< P; tm <= TM of them), kept between chunks
  // in acc_s[i * P1_NT + tid].
  const int G = co_tile / 4, L = P1_NT / G;
  const int tx = tid % G, ty = tid / G;
  const int tm = r2_pixels_per_thread(P, co_tile);

  // w_proj rows [cm0 + step * R2_KC, + R2_KC) x the c_out tile into a slot,
  // zero past C_mid and C_out
  auto stage_w = [&](int cm0, int step, int slot) {
    float* dst = p_s + (size_t)slot * R2_KC * co_tile;
    for (int i = tid; i < R2_KC * G; i += P1_NT) {
      const int r = i / G, j = i % G;
      const int cm = cm0 + step * R2_KC + r, co = co0 + 4 * j;
      float* d = dst + r * co_tile + 4 * j;
      const float* row = w_proj + (size_t)cm * g.C_out;
      if (vec_out) {
        const int n = cm < g.C_mid ? max(0, min(4, g.C_out - co)) : 0;
        cp_async16(d, n ? row + co : w_proj, 4 * n);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = cm < g.C_mid && co + u < g.C_out;
          cp_async4(d + u, ok ? row + co + u : w_proj, ok ? 4 : 0);
        }
      }
    }
  };

  for (int c = c0; c < c1; ++c) {
    const int cm0 = c * CMT;
    if (c > c0) __syncthreads();          // the last chunk is done with d_s and p_s
    p1_expand<CMT, NB>(x, w_exp, e_s, x_s, w_s, g, b, ih0, iw0, cm0, identity, exp_act);
    __syncthreads();
    // the first w_proj rows load while the DW taps run
#pragma unroll
    for (int t = 0; t < P1_SLOTS - 1; ++t) {
      if (t < STEPS) stage_w(cm0, t, t);
      cp_async_commit();
    }
    p1_depthwise<K, S, CMT>(e_s, w_dw, gate_b, d_s, g, cm0, oh0, ow0, dw_act);
    // (the first step's barrier publishes d_s)
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = c > c0 && i < tm ? acc_s[i * P1_NT + tid] : make_float4(0.f, 0.f, 0.f, 0.f);
      acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
    }
#pragma unroll
    for (int t = 0; t < STEPS; ++t) {
      cp_async_wait<P1_SLOTS - 2>();
      __syncthreads();
      if (t + P1_SLOTS - 1 < STEPS) stage_w(cm0, t + P1_SLOTS - 1, (t + P1_SLOTS - 1) % WS);
      cp_async_commit();
      const float* wb = p_s + (size_t)(t % WS) * R2_KC * co_tile + 4 * tx;
      const float* db = d_s + t * R2_KC;
      // rows past C_mid and columns past C_out are 0 on both sides
#pragma unroll
      for (int kk = 0; kk < R2_KC; kk += 4) {
        float4 w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) w[u] = ld4(wb + (kk + u) * co_tile);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int p = ty + i * L;
          if (p < P) {
            const float4 d = ld4(db + p * EP + kk);
            fma4(acc[i], d.x, w[0]);
            fma4(acc[i], d.y, w[1]);
            fma4(acc[i], d.z, w[2]);
            fma4(acc[i], d.w, w[3]);
          }
        }
      }
    }
    if (c + 1 < c1) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (i < tm)
          acc_s[i * P1_NT + tid] = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      continue;
    }
    float* o = out + (size_t)split * g.B * g.out_h * g.out_w * g.C_out;
    const int co = co0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = ty + i * L;
      if (p >= P || co >= g.C_out) continue;
      const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
      if (oh >= g.out_h || ow >= g.out_w) continue;
      float* dst = o + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out + co;
      if (vec_out) {
        st4(dst, acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      } else {
        for (int u = 0; u < 4 && co + u < g.C_out; ++u) dst[u] = acc[i][u];
      }
    }
  }
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

struct Pass1Args {
  const float *x, *w_exp, *w_dw;
  float *pool_partial, *pool;
  int* counters;
  float* dw_out;
  int identity, exp_act, dw_act;
};

struct RecomputeArgs {
  const float *x, *w_exp, *w_dw, *gate, *w_proj;
  float* out;
  int identity, exp_act, dw_act, co_tile, splits, chunks_per_split;
};

template <int K, int S, int CMT, int NB>
cudaError_t launch_pass1_nb(const Pass1Args& a, const Geom& g, cudaStream_t stream) {
  const size_t smem = p1_smem_floats(g.in_rows * g.in_cols, g.tile_h * g.tile_w, CMT, g.C_in,
                                     a.identity) *
                      sizeof(float);
  static const cudaError_t smem_set = set_max_smem(mbconv_pass1_kernel<K, S, CMT, NB>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_mid + CMT - 1) / CMT, g.B);
  mbconv_pass1_kernel<K, S, CMT, NB><<<grid, P1_NT, smem, stream>>>(
      a.x, a.w_exp, a.w_dw, a.pool_partial, a.pool, a.counters, a.dw_out, g, a.identity,
      a.exp_act, a.dw_act);
  return cudaGetLastError();
}

template <int K, int S, int CMT, int NB, int TM>
cudaError_t launch_recompute_tm(const RecomputeArgs& a, const Geom& g, cudaStream_t stream) {
  const size_t smem = r2_smem_floats(g.in_rows * g.in_cols, g.tile_h * g.tile_w, CMT, g.C_in,
                                     a.identity, a.co_tile) *
                      sizeof(float);
  static const cudaError_t smem_set =
      set_max_smem(mbconv_pass2_recompute_kernel<K, S, CMT, NB, TM>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_out + a.co_tile - 1) / a.co_tile, g.B * a.splits);
  mbconv_pass2_recompute_kernel<K, S, CMT, NB, TM><<<grid, P1_NT, smem, stream>>>(
      a.x, a.w_exp, a.w_dw, a.gate, a.w_proj, a.out, g, a.identity, a.exp_act, a.dw_act,
      a.co_tile, a.chunks_per_split);
  return cudaGetLastError();
}

// TM: R2_TM_SMALL where it covers the projection pixels per thread.
template <int K, int S, int CMT, int NB>
cudaError_t launch_recompute_nb(const RecomputeArgs& a, const Geom& g, cudaStream_t stream) {
  if (r2_pixels_per_thread(g.tile_h * g.tile_w, a.co_tile) <= R2_TM_SMALL)
    return launch_recompute_tm<K, S, CMT, NB, R2_TM_SMALL>(a, g, stream);
  return launch_recompute_tm<K, S, CMT, NB, R2_TM>(a, g, stream);
}

// The c_mid tile (pass1_cm_tile), then NB, the pixel blocks an expanding
// thread holds per pass: the fewest of 1, 2 and P1_MAX_NB that cover the
// window in one pass (else P1_MAX_NB, in passes).
#define MBCONV_CM_NB_SWITCH(LAUNCH, ARGS, G, STREAM)                                   \
  {                                                                                    \
    const int q = (G).in_rows * (G).in_cols;                                           \
    if (p1_cm_tile((G).C_mid) == 64) {                                                 \
      const int nb = p1_blocks_per_thread(q, 64);                                      \
      if (nb == 1) return LAUNCH<K, S, 64, 1>(ARGS, G, STREAM);                        \
      if (nb == 2) return LAUNCH<K, S, 64, 2>(ARGS, G, STREAM);                        \
      return LAUNCH<K, S, 64, P1_MAX_NB>(ARGS, G, STREAM);                             \
    }                                                                                  \
    const int nb = p1_blocks_per_thread(q, 32);                                        \
    if (nb == 1) return LAUNCH<K, S, 32, 1>(ARGS, G, STREAM);                          \
    if (nb == 2) return LAUNCH<K, S, 32, 2>(ARGS, G, STREAM);                          \
    return LAUNCH<K, S, 32, P1_MAX_NB>(ARGS, G, STREAM);                               \
  }

template <int K, int S>
cudaError_t launch_pass1(const Pass1Args& a, const Geom& g, cudaStream_t stream) {
  MBCONV_CM_NB_SWITCH(launch_pass1_nb, a, g, stream)
}

template <int K, int S>
cudaError_t launch_recompute(const RecomputeArgs& a, const Geom& g, cudaStream_t stream) {
  MBCONV_CM_NB_SWITCH(launch_recompute_nb, a, g, stream)
}

#undef MBCONV_CM_NB_SWITCH

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

int mbconv_max_tile_pixels() { return R2_MAXP; }
int mbconv_recompute_k_chunk() { return R2_KC; }
int mbconv_pass1_ci_chunk() { return P1_CI; }
int mbconv_pass1_max_tile_pixels() { return P1_MAXP; }
int mbconv_pass1_cm_tile(int C_mid) { return p1_cm_tile(C_mid); }
long long mbconv_pass1_smem_bytes(int K, int S, int tile_h, int tile_w, int C_in,
                                  int C_mid, int identity) {
  const int q = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  return (long long)(p1_smem_floats(q, tile_h * tile_w, p1_cm_tile(C_mid), C_in, identity) *
                     sizeof(float));
}
long long mbconv_recompute_smem_bytes(int K, int S, int tile_h, int tile_w, int C_in,
                                      int C_mid, int co_tile, int identity) {
  const int q = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  return (long long)(r2_smem_floats(q, tile_h * tile_w, p1_cm_tile(C_mid), C_in, identity,
                                    co_tile) *
                     sizeof(float));
}
int mbconv_retain_k_chunk() { return R_BK; }
const char* mbconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// pool_partial, pool and counters all set (se on) or all null; counters
// holds B * ceil(C_mid / pass1_cm_tile) zeros and is left so.
int mbconv_pass1(const float* x, const float* w_exp, const float* w_dw,
                 float* pool_partial, float* pool, int* counters, float* dw_out, int B,
                 int H, int W, int C_in, int C_mid, int K, int S, int out_h, int out_w,
                 int pad_top, int pad_left, int tile_h, int tile_w, int identity,
                 int exp_act, int dw_act, void* stream) {
  const Geom g = make_geom(B, H, W, C_in, C_mid, 1, K, S, out_h, out_w, pad_top,
                           pad_left, tile_h, tile_w);
  if (!geom_ok(g, P1_MAXP)) return (int)cudaErrorInvalidValue;
  if (!pool_partial != !pool || !pool_partial != !counters) return (int)cudaErrorInvalidValue;
  const Pass1Args a{x, w_exp, w_dw, pool_partial, pool, counters, dw_out,
                    identity, exp_act, dw_act};
  MBCONV_KS_SWITCH(K, S, launch_pass1<KK, SS>(a, g, (cudaStream_t)stream))
}

// out (splits, B, out_h, out_w, C_out): the output itself for splits == 1,
// else the per-split partials.
int mbconv_pass2_recompute(const float* x, const float* w_exp, const float* w_dw,
                           const float* gate, const float* w_proj, float* out, int B,
                           int H, int W, int C_in, int C_mid, int C_out, int K, int S,
                           int out_h, int out_w, int pad_top, int pad_left, int tile_h,
                           int tile_w, int identity, int exp_act, int dw_act, int co_tile,
                           int splits, void* stream) {
  const Geom g = make_geom(B, H, W, C_in, C_mid, C_out, K, S, out_h, out_w, pad_top,
                           pad_left, tile_h, tile_w);
  if (!geom_ok(g, R2_MAXP)) return (int)cudaErrorInvalidValue;
  if (co_tile != 16 && co_tile != 32 && co_tile != 64 && co_tile != 128)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (C_mid + p1_cm_tile(C_mid) - 1) / p1_cm_tile(C_mid);
  if (splits <= 0 || (long long)B * splits > 65535) return (int)cudaErrorInvalidValue;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((splits - 1) * cps >= n_chunks) return (int)cudaErrorInvalidValue;  // empty split
  const RecomputeArgs a{x, w_exp, w_dw, gate, w_proj, out, identity, exp_act, dw_act,
                        co_tile, splits, cps};
  MBCONV_KS_SWITCH(K, S, launch_recompute<KK, SS>(a, g, (cudaStream_t)stream))
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
