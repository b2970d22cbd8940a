// Two-pass fused MBConv kernels for Hopper (sm_90a): fp32 on CUDA cores, the
// bf16 build's expand and retain GEMM on bf16 tensor cores.
//
// Replaces the three Pallas TPU kernels of the JAX package's MBConv path
// (src/repro/kernels/convdk_mbconv.py):
//
//   mbconv_pass1_kernel            <- _mbconv_pass1_kernel            (:118),
//                                     its cross-strip SE pool sum
//                                     (:151-163) folded into the epilogue
//   mbconv_pass2_recompute_kernel  <- _mbconv_pass2_recompute_kernel  (:169)
//   mbconv_pass2_retain_kernel     <- _mbconv_pass2_retain_kernel     (:220),
//                                     its c_mid accumulation across grid
//                                     steps (:245-251), and the recompute
//                                     one's, folded into each kernel's
//                                     split launch (splitk.cuh)
//
// What they compute (NHWC activations, w_exp (C_in, C_mid), w_dw
// (k, k, C_mid), w_proj (C_mid, C_out), all in one storage type T):
//
//   pass 1     expand 1x1 (reduce C_in) -> exp_act -> k x k / s depthwise
//              -> dw_act; per-tile SE pool partial sums and their sum, the
//              pool (B, C_mid), and under retain the DW tensor
//              (B, out_h, out_w, C_mid).
//   recompute  expand + DW again, x SE gate, projection 1x1 (reduce C_mid).
//   retain     re-read the DW tensor, x SE gate, projection 1x1.
//   split-K    where retain or recompute splits C_mid over the grid, the
//              split launch's last CTA per output tile sums the splits'
//              partial products in split order (B3', folded in).
//
// The Pallas grids reduce over *sequential* grid steps (c_in innermost,
// c_mid for the projection, strips for the pool); CTAs have no order, so a
// reduction either loops inside one CTA, or goes through partials summed in
// a fixed order by the CTA that finishes last (an arrival counter elects
// it; no value is ever added atomically), so results repeat bit for bit.  SAME padding is a bounds mask everywhere: an input
// pixel outside the image reads as 0, so its expanded value is exp_act(0),
// exactly what the JAX kernel's zero-padded input gives.  Ragged pixels,
// channels and rows are masked in the kernels; the wrappers pad nothing.
// The fp32 build runs fp32 FMAs on CUDA cores and no tensor cores: a
// 1xTF32 product misses the JAX suite's 1e-4 fp32 bar.  The bf16 build's
// expand (pass 1's and B2's) and retain GEMM run on tensor cores
// ("Storage type" below).
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
// tile; the bf16 build's runs on tensor cores, p1_expand_mma): in fp32
// each thread keeps NB register blocks of 4 pixels x 4 channels of
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
// one persistent zeroed buffer per device, shared with pass 2's and the
// separable kernel's split folds, which assumes one stream at a time runs
// them, as the port does.
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
// tensor and the last CTA of each (pixel tile, c_out tile, image) sums
// them in split order (splitk.cuh).
//
// Retain (the projection is a GEMM: M = B * out_h * out_w rows, K = C_mid,
// N = C_out; bound by operations, and in practice by latency at B0's
// sizes).  It has no halo, so (B, out_h, out_w) flattens into M and rows
// of different images share a CTA.  Each CTA owns a BM x BN tile; K goes in
// R_BK-deep chunks, staged by 16-byte cp.async copies into an R_STAGES ring.
// In fp32 (the bf16 build's GEMM: retain_mma, on tensor cores), as a chunk
// of A is consumed it is multiplied by the SE gate of its row's
// image (m / (out_h * out_w)), loaded into registers a chunk ahead, which
// rounds d * gate before the product as the plain version does, and stored
// K-major, so the inner loop reads float4s of A and of B into a TM x 4
// register tile.  Where the M x N tiles leave the card short of CTAs (most
// blocks below 28x28), K is split over the grid's z; the splits' partials
// go to a scratch tensor and the last CTA of each output tile sums them in
// split order (splitk.cuh), with no atomics on values, so results repeat
// bit for bit.  Tile and split count come from core.autotune.retain_plan.
//
// The split fold (B3', in retain and recompute).  A separate reduce kernel
// spread the partials' read over all SMs but cost a launch per split
// block; in the fold the last CTA of a tile reads splits x tile fp32
// values through one SM, so its sum keeps several items' loads of several
// splits in flight per thread.  That tail is bound by the read's latency
// where the splits are deep (B0 224 b8's blocks 12-14: 18 splits of a
// 64 x 64 tile, 288 KB; V2-S 384 b8's 12x12 blocks: 8 of a 128 x 64
// tile, 256 KB), where the fold is slower than the separate reduce was
// (PERF.md).
//
// SiLU and sigmoid use __expf and __fdividef (a few ulp), in every kernel
// of this file.
//
// Storage type.  Every kernel is a template over the storage type T of
// the activations and the weights (float or __nv_bfloat16), the JAX
// kernels' x.dtype; each build of this file instantiates one of them for
// the C interface (float, or __nv_bfloat16 with -DBF16_STORAGE), so the two
// build in parallel.  Whatever T, every product is exact or fp32 and every
// sum fp32, as the Pallas kernels' preferred_element_type=float32: the
// cp.async rings hold T (the copies move bytes unconverted); the expanded
// window, the DW tile, the SE pool partials and pool, the gate, the
// projection sums and the split partials are fp32; the retained DW tensor
// and the block output round once to T (the Pallas kernels' dwo_ref /
// o_ref casts).  A 16-byte fp32 copy of 4 channels is an 8-byte copy at
// bf16, so C_in % 4 == 0 aligns both; ragged channels take the element
// path (a plain load at bf16, which cp.async cannot copy in 2 bytes).
// The fp32 kernels convert nothing; the bf16 depthwise and B2's
// projection convert each value to fp32 as they read it.
//
// bf16 on tensor cores (mma.sync m16n8k16, fp32 accumulation, operands by
// ldmatrix from rings whose rows are padded to odd multiples of 16 bytes):
//
//   expand     (pass 1 and B2, p1_expand_mma) x (bf16) times w_exp (bf16):
//              a bf16 x bf16 product is exact in fp32, so one mma per k16
//              step is the fp32 expand's function.  Each warp owns m16 row
//              groups of the halo'd window across the c_mid tile.  Pass 1
//              is then bound by the fp32 depthwise and its loads, not by
//              the expand; B2's projection and every depthwise stay fp32
//              FMAs.
//   retain     (retain_mma) A = d x gate, rounded once in fp32 as the plain
//              version rounds it, is not a bf16 value: one mma would round
//              it again.  It is split exactly into three bf16 terms (8
//              significant bits each, fp32's 24 together: bf16x3_split2,
//              by truncation, with integer masks and byte permutes rather
//              than the conversion pipe), once per CTA, and three mmas on
//              the same B fragment add hi w + mid w + lo w, each product
//              exact in fp32.  Without SE, A is the bf16 DW tensor itself:
//              one mma.  Bound by its bytes at the bf16 rate; at B0's
//              sizes, in practice, by latency and the split-K partials'
//              round trip.
//
// No operand is rounded to a single bf16 and no product is TF32.  HMMA's
// fp32 additions round in another order than FMAs, so the bf16 kernels are
// held to 1 bf16 ulp of the plain fp32 sum (chip_smoke.py's
// _bf16_verdict), not bit for bit to it; each still repeats bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

#include <type_traits>

#include "mma.cuh"
#include "splitk.cuh"
#include "storage.cuh"

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

// the bf16 build's tensor-core products (pass 1's expand, B2's, retain)
constexpr int ROW_PAD16 = 8;            // bf16 padding per staged w_exp / retain ring row

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

// Bytes of the staging ring, its elements of eb bytes each (x and w_exp
// in the storage type).  fp32: the window's pixels rounded up to P1_TP, at
// P1_CI + P1_PAD floats each, and P1_CI w_exp rows of CMT.  bf16 (the
// tensor-core expand): the window rounded up to whole m16 row groups, at
// P1_CI elements (32 bytes, swizzled: p1_xs16) each, and rows of CMT +
// ROW_PAD16; ldmatrix reads both without bank conflicts.
__host__ __device__ inline size_t p1_stage_bytes(int Q, int CMT, int C_in, int identity,
                                                 int eb) {
  if (identity) return 0;
  if (eb == 2)
    return p1_slots(C_in) *
           ((size_t)(Q + MMA_M - 1) / MMA_M * MMA_M * P1_CI + (size_t)P1_CI * (CMT + ROW_PAD16)) *
           eb;
  const size_t qp = (size_t)((Q + P1_TP - 1) / P1_TP) * P1_TP;
  return p1_slots(C_in) * (qp * (P1_CI + P1_PAD) + (size_t)P1_CI * CMT) * eb;
}

// One pass-1 CTA: the fp32 window, then one region holding the staging
// ring during the expand and the fp32 DW tile and pool rows after it.
// core.autotune.pass1_smem_bytes mirrors this.
__host__ __device__ inline size_t p1_smem_bytes(int Q, int P, int CMT, int C_in,
                                                int identity, int eb) {
  const size_t stage = p1_stage_bytes(Q, CMT, C_in, identity, eb);
  const size_t after =
      ((size_t)P * (CMT + P1_PAD) + (size_t)(P1_NT / (CMT / 4)) * CMT) * sizeof(float);
  return p1_window_floats(Q, CMT) * sizeof(float) + (stage > after ? stage : after);
}

template <int K, typename T>
__device__ __forceinline__ void load_dw_taps(const T* __restrict__ w_dw,
                                             float (&wd)[K * K], int C_mid,
                                             int cm) {
#pragma unroll
  for (int t = 0; t < K * K; ++t)
    wd[t] = cm < C_mid ? ldg_f(w_dw + (size_t)t * C_mid + cm) : 0.f;
}

// Element offset of channel c (0..15) of staged pixel q in a bf16 x ring
// slot: 16 elements a pixel, the two 16-byte halves swapped on every other
// run of 4 pixels, so the 8 rows an ldmatrix phase reads (8 pixels, one
// half each) fall in 8 different bank groups with no padding.
__host__ __device__ constexpr int p1_xs16(int q, int c) {
  return q * P1_CI + (((c / 8) ^ ((q / 4) & 1)) * 8) + c % 8;
}

// The bf16 build's expand: pass 1's window GEMM (window pixels x C_in ->
// the c_mid tile) on tensor cores.  Each ring slot stages P1_CI = 16 input
// channels, one k16 step: the window's pixels at P1_CI bf16 each (p1_xs16;
// 16-byte copies where C_in % 8 == 0, else 8-byte ones) and the chunk's
// w_exp rows at CMT + ROW_PAD16.  Warp w owns the m16 row groups w, w + 8, ... of the
// window across the whole c_mid tile (CMT / 8 n8 tiles): MB of them per
// pass, as many fp32 sums per thread as the fp32 expand's NB register
// blocks (MB = NB * 32 / CMT m16 groups, at least 1, cover at least the
// pixels NB blocks do, so both take the same passes).  Per chunk a warp
// loads the B fragments of the whole tile once (ldmatrix.trans) and one A
// fragment per row group (ldmatrix); a bf16 x bf16 product is exact in
// fp32 and the mma sums in fp32, the fp32 expand's function.  Ring rows
// past the window hold whatever was there (A rows are independent, and
// their sums are never stored); out-of-image pixels and channels past C_in
// are zero-filled, so padding expands to exp_act(0).  The epilogue applies
// exp_act and writes the fp32 window e_s.
template <int CMT, int NB>
__device__ __forceinline__ void p1_expand_mma(const __nv_bfloat16* __restrict__ x,
                                              const __nv_bfloat16* __restrict__ w_exp,
                                              float* e_s, __nv_bfloat16* ring, const Geom& g,
                                              int b, int ih0, int iw0, int cm0, int exp_act) {
  using T = __nv_bfloat16;
  constexpr int EP = CMT + P1_PAD;      // floats per expanded pixel
  constexpr int XP = P1_CI;             // elements per staged input pixel
  constexpr int WP = CMT + ROW_PAD16;   // elements per staged w_exp row
  constexpr int NJ = CMT / 8;           // n8 tiles of the c_mid tile
  constexpr int WARPS = P1_NT / 32;
  constexpr int MB = NB * 32 / CMT > 0 ? NB * 32 / CMT : 1;
  const int Q = g.in_rows * g.in_cols, Q16 = (Q + MMA_M - 1) / MMA_M * MMA_M;
  const int groups = Q16 / MMA_M;
  const int slots = p1_slots(g.C_in);
  T* x_s = ring;                                   // slots x Q16 x XP, then
  T* w_s = ring + (size_t)slots * Q16 * XP;        // slots x P1_CI x WP
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool vec_mid = (g.C_mid & 3) == 0, vec8 = (g.C_in & 7) == 0;

  auto stage = [&](int chunk, int slot) {
    const int ci0 = chunk * P1_CI;
    T* xb = x_s + (size_t)slot * Q16 * XP;
    T* wb = w_s + slot * P1_CI * WP;
    const int per = vec8 ? P1_CI / 8 : P1_CI / 4;  // copies per pixel
    for (int i = tid; i < Q * per; i += P1_NT) {
      const int q = i / per, j = i % per;
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const int ci = ci0 + (vec8 ? 8 : 4) * j;
      const bool ok = ci < g.C_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const T* src = ok ? x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci : x;
      if (vec8)
        cp_async<16>(xb + p1_xs16(q, 8 * j), src, ok ? 16 : 0);
      else
        cp4(xb + p1_xs16(q, 4 * j), src, ok ? 4 : 0);
    }
    for (int i = tid; i < P1_CI * (CMT / 4); i += P1_NT) {
      const int r = i / (CMT / 4), j = i % (CMT / 4);
      const int ci = ci0 + r, cm = cm0 + 4 * j;
      T* dst = wb + r * WP + 4 * j;
      const T* row = w_exp + (size_t)ci * g.C_mid;
      if (vec_mid) {
        const int n = ci < g.C_in ? max(0, min(4, g.C_mid - cm)) : 0;
        cp4(dst, n ? row + cm : w_exp, n);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = ci < g.C_in && cm + u < g.C_mid;
          cp1(dst + u, ok ? row + cm + u : w_exp, ok);
        }
      }
    }
  };

  // Ring of P1_SLOTS as the fp32 expand's: chunk c + 2 is staged into the
  // slot chunk c - 1 used, once the barrier shows every warp done with it.
  const int n_chunks = (g.C_in + P1_CI - 1) / P1_CI;
  const int fr = lane / 4, fc = 2 * (lane % 4);   // this lane's fragment row, column
  for (int pass0 = 0; pass0 < groups; pass0 += MB * WARPS) {
    float acc[MB][NJ][4];
#pragma unroll
    for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int nj = 0; nj < NJ; ++nj)
        acc[mb][nj][0] = acc[mb][nj][1] = acc[mb][nj][2] = acc[mb][nj][3] = 0.f;
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
      const T* xb = x_s + (size_t)(c % slots) * Q16 * XP;
      const T* wb = w_s + (c % slots) * P1_CI * WP;
      // B fragments of the whole c_mid tile, two n8 tiles per ldmatrix
      unsigned bf[NJ / 2][4];
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j)
        ldsm_x4_trans(bf[j], wb + (lane % 16) * WP + 16 * j + 8 * (lane / 16));
      // chunk rows past C_in were zero-filled on both sides: they add 0
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int gi = pass0 + warp + mb * WARPS;
        if (gi >= groups) continue;       // uniform across the warp
        unsigned af[4];
        ldsm_x4(af, xb + p1_xs16(gi * MMA_M + lane % 16, 8 * (lane / 16)));
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          mma_bf16(acc[mb][nj], af, bf[nj / 2][2 * (nj % 2)], bf[nj / 2][2 * (nj % 2) + 1]);
      }
    }
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int gi = pass0 + warp + mb * WARPS;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = gi * MMA_M + fr + 8 * h;
        if (gi >= groups || q >= Q) continue;
#pragma unroll
        for (int nj = 0; nj < NJ; ++nj)
          *reinterpret_cast<float2*>(e_s + q * EP + 8 * nj + fc) =
              make_float2(act_apply(acc[mb][nj][2 * h], exp_act),
                          act_apply(acc[mb][nj][2 * h + 1], exp_act));
      }
    }
  }
}

// Expand 1x1 + exp_act of the halo'd window at (ih0, iw0), c_mid channels
// [cm0, cm0 + CMT), into the fp32 e_s (QP x (CMT + P1_PAD)), staging through
// the ring (in T, p1_stage_bytes): fp32 FMAs on CUDA cores, or at bf16 the
// tensor-core expand above.  The caller's barrier publishes e_s.
template <int CMT, int NB, typename T>
__device__ __forceinline__ void p1_expand(const T* __restrict__ x,
                                          const T* __restrict__ w_exp, float* e_s,
                                          T* ring, const Geom& g, int b,
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
  T* x_s = ring;                                   // slots x QP x XP, then
  T* w_s = ring + (size_t)slots * QP * XP;         // slots x P1_CI x CMT

  if (identity) {
    // C_in == C_mid (a multiple of 4): the window's channel tile straight
    // into e_s (16-byte copies in fp32; 8-byte loads converted in bf16),
    // then exp_act in place
    for (int i = tid; i < Q * CG; i += P1_NT) {
      const int q = i / CG, j = i % CG;
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const int cm = cm0 + 4 * j;
      const bool ok = cm < g.C_mid && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      const T* src = ok ? x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + cm : x;
      if constexpr (std::is_same<T, float>::value) {
        cp4(e_s + q * EP + 4 * j, src, ok ? 4 : 0);
      } else {
        const float4 v = ok ? ld4(src) : make_float4(0.f, 0.f, 0.f, 0.f);
        st4(e_s + q * EP + 4 * j, v.x, v.y, v.z, v.w);
      }
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
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    p1_expand_mma<CMT, NB>(x, w_exp, e_s, ring, g, b, ih0, iw0, cm0, exp_act);
    return;
  }
  auto stage = [&](int chunk, int slot) {
    const int ci0 = chunk * P1_CI;
    T* xb = x_s + (size_t)slot * QP * XP;
    T* wb = w_s + slot * P1_CI * CMT;
    for (int i = tid; i < Q * (P1_CI / 4); i += P1_NT) {
      const int q = i / (P1_CI / 4), j = i % (P1_CI / 4);
      const int ih = ih0 + q / g.in_cols, iw = iw0 + q % g.in_cols;
      const int ci = ci0 + 4 * j;
      const bool ok = ci < g.C_in && ih >= 0 && ih < g.H && iw >= 0 && iw < g.W;
      cp4(xb + q * XP + 4 * j,
          ok ? x + ((size_t)(b * g.H + ih) * g.W + iw) * g.C_in + ci : x, ok ? 4 : 0);
    }
    for (int i = tid; i < P1_CI * CG; i += P1_NT) {
      const int r = i / CG, j = i % CG;
      const int ci = ci0 + r, cm = cm0 + 4 * j;
      T* dst = wb + r * CMT + 4 * j;
      const T* row = w_exp + (size_t)ci * g.C_mid;
      if (vec_mid) {
        const int n = ci < g.C_in ? max(0, min(4, g.C_mid - cm)) : 0;
        cp4(dst, n ? row + cm : w_exp, n);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = ci < g.C_in && cm + u < g.C_mid;
          cp1(dst + u, ok ? row + cm + u : w_exp, ok);
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
      const T* xb = x_s + (size_t)(c % slots) * QP * XP;
      const T* wb = w_s + (c % slots) * P1_CI * CMT + tc * 4;
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
template <int K, int S, int CMT, typename T>
__device__ __forceinline__ void p1_depthwise(const float* e_s, const T* __restrict__ w_dw,
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
// x, w_exp, w_dw and dw_out in T; the pool partials and the pool fp32.
template <int K, int S, int CMT, int NB, typename T>
__global__ void __launch_bounds__(P1_NT)
mbconv_pass1_kernel(const T* __restrict__ x, const T* __restrict__ w_exp,
                    const T* __restrict__ w_dw, float* __restrict__ pool_partial,
                    float* __restrict__ pool, int* __restrict__ counters,
                    T* __restrict__ dw_out, Geom g, int identity, int exp_act,
                    int dw_act) {
  constexpr int EP = CMT + P1_PAD;      // floats per expanded / DW pixel
  constexpr int CG = CMT / 4;           // float4 channel groups
  constexpr int NG = P1_NT / CG;        // pixel lanes of the pool

  extern __shared__ float4 smem4[];
  const int Q = g.in_rows * g.in_cols, QP = (Q + P1_TP - 1) / P1_TP * P1_TP;
  const int P = g.tile_h * g.tile_w;
  float* e_s = reinterpret_cast<float*>(smem4);          // QP x EP
  T* ring = reinterpret_cast<T*>(e_s + (size_t)QP * EP); // the expand's ring
  float* d_s = reinterpret_cast<float*>(ring);           // P x EP after the expand
  float* r_s = d_s + (size_t)P * EP;                     // NG x CMT

  const int tile = blockIdx.x, cm0 = blockIdx.y * CMT, b = blockIdx.z;
  const int oh0 = (tile / g.n_tw) * g.tile_h, ow0 = (tile % g.n_tw) * g.tile_w;
  const int ih0 = oh0 * S - g.pad_top, iw0 = ow0 * S - g.pad_left;
  const int tid = threadIdx.x;
  const bool vec_mid = (g.C_mid & 3) == 0;

  p1_expand<CMT, NB, T>(x, w_exp, e_s, ring, g, b, ih0, iw0, cm0, identity, exp_act);
  __syncthreads();
  p1_depthwise<K, S, CMT, T>(e_s, w_dw, nullptr, d_s, g, cm0, oh0, ow0, dw_act);
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
    // Threadfence reduction, as a grid barrier's arrival (splitk.cuh
    // count_in): after the CTA's barrier one thread counts the CTA in; the
    // other threads write the DW tile meanwhile.
    __syncthreads();
    if (tid == 0) *last = count_in(counters + (size_t)b * gridDim.y + blockIdx.y, gridDim.x);
  }

  // ---- the retained DW tile, 4 channels a store along C_mid, rounded
  // once to T ----
  if (dw_out) {
    for (int i = tid; i < P * CG; i += P1_NT) {
      const int p = i / CG, j = i % CG;
      const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
      const int cm = cm0 + 4 * j;
      if (oh >= g.out_h || ow >= g.out_w || cm >= g.C_mid) continue;
      T* dst = dw_out + ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_mid + cm;
      const float4 d = ld4(d_s + p * EP + 4 * j);
      if (vec_mid) {
        st4(dst, d.x, d.y, d.z, d.w);
      } else {
        const float v[4] = {d.x, d.y, d.z, d.w};
        for (int u = 0; u < 4 && cm + u < g.C_mid; ++u) dst[u] = from_f<T>(v[u]);
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

// Bytes of the region after the expand: the fp32 gated DW tile and the
// w_proj ring (in the storage type, eb bytes an element).
__host__ __device__ inline size_t r2_after_bytes(int P, int CMT, int co_tile, int eb) {
  return (size_t)P * (CMT + P1_PAD) * sizeof(float) +
         (size_t)r2_slots(CMT) * R2_KC * co_tile * eb;
}

// Shared-memory bytes of one B2 CTA: the fp32 expanded window, then one
// region holding the staging ring during the expand and the gated DW tile
// and the w_proj ring after it, then the fp32 projection sums kept between
// c_mid chunks (a float4 per thread and pixel).
// core.autotune.recompute_smem_bytes mirrors this.
__host__ __device__ inline size_t r2_smem_bytes(int Q, int P, int CMT, int C_in, int identity,
                                                int co_tile, int eb) {
  const size_t stage = p1_stage_bytes(Q, CMT, C_in, identity, eb);
  const size_t after = r2_after_bytes(P, CMT, co_tile, eb);
  return p1_window_floats(Q, CMT) * sizeof(float) + (stage > after ? stage : after) +
         (size_t)r2_pixels_per_thread(P, co_tile) * P1_NT * 4 * sizeof(float);
}

// grid (n_tiles, ceil(C_out / co_tile), splits * B), z = split * B + b;
// co_tile one of 16, 32, 64, 128.  x, w_exp, w_dw, w_proj in T; gate (B,
// C_mid) fp32 or null (se off).  Split z sums c_mid chunks
// [z * chunks_per_split, (z + 1) * chunks_per_split) into the fp32
// partial + z * B * out_h * out_w * C_out, and the last split CTA of each
// (pixel tile, c_out tile, image) to arrive at its counter sums the
// splits' partials in split order into out (recompute_fold); an unsplit
// launch (partial and counters null) writes out itself.  out rounds once
// to T.  The projection sums live in
// registers only while a chunk is projected and in shared memory between
// chunks, so the expand runs with about pass 1's registers: three CTAs an
// SM at NB = 1, two above.  TM: R2_TM_SMALL or R2_TM, at least the
// projection pixels per thread.
template <int K, int S, int CMT, int NB, int TM, typename T>
__global__ void __launch_bounds__(P1_NT, NB == 1 ? 3 : 2)
mbconv_pass2_recompute_kernel(const T* __restrict__ x, const T* __restrict__ w_exp,
                              const T* __restrict__ w_dw, const float* __restrict__ gate,
                              const T* __restrict__ w_proj, float* __restrict__ partial,
                              int* __restrict__ counters, T* __restrict__ out, Geom g,
                              int identity, int exp_act, int dw_act, int co_tile,
                              int chunks_per_split) {
  constexpr int EP = CMT + P1_PAD;
  constexpr int STEPS = CMT / R2_KC;    // w_proj ring steps per chunk
  constexpr int WS = r2_slots(CMT);

  extern __shared__ float4 smem4[];
  const int Q = g.in_rows * g.in_cols, QP = (Q + P1_TP - 1) / P1_TP * P1_TP;
  const int P = g.tile_h * g.tile_w;
  float* e_s = reinterpret_cast<float*>(smem4);            // QP x EP
  char* region = reinterpret_cast<char*>(e_s + (size_t)QP * EP);
  T* ring = reinterpret_cast<T*>(region);                  // the expand's ring,
  float* d_s = reinterpret_cast<float*>(region);           // then P x EP
  T* p_s = reinterpret_cast<T*>(d_s + (size_t)P * EP);     // and WS x R2_KC x co_tile
  const size_t stage = p1_stage_bytes(Q, CMT, g.C_in, identity, sizeof(T));
  const size_t after = r2_after_bytes(P, CMT, co_tile, sizeof(T));
  float4* acc_s = reinterpret_cast<float4*>(region + (stage > after ? stage : after));

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
    T* dst = p_s + (size_t)slot * R2_KC * co_tile;
    for (int i = tid; i < R2_KC * G; i += P1_NT) {
      const int r = i / G, j = i % G;
      const int cm = cm0 + step * R2_KC + r, co = co0 + 4 * j;
      T* d = dst + r * co_tile + 4 * j;
      const T* row = w_proj + (size_t)cm * g.C_out;
      if (vec_out) {
        const int n = cm < g.C_mid ? max(0, min(4, g.C_out - co)) : 0;
        cp4(d, n ? row + co : w_proj, n);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const bool ok = cm < g.C_mid && co + u < g.C_out;
          cp1(d + u, ok ? row + co + u : w_proj, ok);
        }
      }
    }
  };

  for (int c = c0; c < c1; ++c) {
    const int cm0 = c * CMT;
    if (c > c0) __syncthreads();          // the last chunk is done with d_s and p_s
    p1_expand<CMT, NB, T>(x, w_exp, e_s, ring, g, b, ih0, iw0, cm0, identity, exp_act);
    __syncthreads();
    // the first w_proj rows load while the DW taps run
#pragma unroll
    for (int t = 0; t < P1_SLOTS - 1; ++t) {
      if (t < STEPS) stage_w(cm0, t, t);
      cp_async_commit();
    }
    p1_depthwise<K, S, CMT, T>(e_s, w_dw, gate_b, d_s, g, cm0, oh0, ow0, dw_act);
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
      const T* wb = p_s + (size_t)(t % WS) * R2_KC * co_tile + 4 * tx;
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
    const int co = co0 + 4 * tx;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int p = ty + i * L;
      if (p >= P || co >= g.C_out) continue;
      const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
      if (oh >= g.out_h || ow >= g.out_w) continue;
      const size_t at = ((size_t)(b * g.out_h + oh) * g.out_w + ow) * g.C_out + co;
      if (partial)
        store_row(partial + (size_t)split * g.B * g.out_h * g.out_w * g.C_out + at, acc[i],
                  vec_out, g.C_out - co);
      else
        store_row(out + at, acc[i], vec_out, g.C_out - co);
    }
  }
  if (!partial) return;

  // ---- the split fold (B3'): the last of the splits' CTAs of this
  // (pixel tile, c_out tile, image) sums their partials in split order ----
  cp_async_wait<0>();
  __syncthreads();                      // every partial of this CTA stored; smem free
  int* last = reinterpret_cast<int*>(smem4);
  if (tid == 0)
    *last = count_in(counters + ((size_t)b * gridDim.y + blockIdx.y) * gridDim.x + tile,
                     gridDim.z / g.B);
  __syncthreads();
  if (!*last) return;
  // one item in flight a thread: the expand runs at a register cap
  fold_tile<1, 4>(
      partial, out, (size_t)g.B * g.out_h * g.out_w * g.C_out, gridDim.z / g.B, P, co_tile,
      g.C_out - co0, vec_out, tid, P1_NT,
      [&](int p) -> long long {
        const int oh = oh0 + p / g.tile_w, ow = ow0 + p % g.tile_w;
        return oh < g.out_h && ow < g.out_w
                   ? ((long long)(b * g.out_h + oh) * g.out_w + ow) * g.C_out + co0
                   : -1;
      },
      [](float v) { return v; });
}

// ---------------------------------------------------------------------------
// retain (B3): a split-K GEMM with the SE gate folded into A
// ---------------------------------------------------------------------------

// A BM x BN CTA tile.  fp32: NT threads, TM x 4 outputs each, the A and B
// rings (eb bytes an element) and two fp32 K-major A copies.  bf16: NT16
// threads, one warp per m16 row group across all BN columns, and the rings
// alone, A rows at AP16 and B rows at BP16 elements (an odd multiple of 16
// bytes: ldmatrix reads them without bank conflicts).
template <int BM, int BN, int TM>
struct RetainTile {
  static constexpr int NT = (BM / TM) * (BN / 4);    // threads per CTA
  static constexpr int NT16 = BM / MMA_M * 32;       // ... at bf16
  static constexpr int AP = R_BK + 4;                // elements per staged A row
  static constexpr int AP16 = R_BK + ROW_PAD16;      // ... at bf16 (80 bytes)
  static constexpr int BP16 = BN + ROW_PAD16;        // bf16 elements per staged B row
  __host__ __device__ static constexpr int threads(int eb) { return eb == 2 ? NT16 : NT; }
  __host__ __device__ static constexpr size_t ring_bytes(int eb) {
    return eb == 2 ? (R_STAGES * (size_t)BM * AP16 + R_STAGES * (size_t)R_BK * BP16) * eb
                   : (R_STAGES * (size_t)BM * AP + R_STAGES * (size_t)R_BK * BN) * eb;
  }
  __host__ __device__ static constexpr size_t smem_bytes(int eb) {
    return ring_bytes(eb) + (eb == 2 ? 0 : 2 * (size_t)R_BK * BM * sizeof(float));
  }
};

// The split fold of a retain launch (B3'): after every thread of the CTA
// stored its fp32 partial of the BM x BN tile, the last of the tile's
// gridDim.z split CTAs to arrive at the tile's counter sums their partials
// in split order into C, rounded once to T (splitk.cuh).
template <int BM, int BN, int NT, typename T>
__device__ __forceinline__ void retain_fold(const float* __restrict__ partial,
                                            int* __restrict__ counters, T* __restrict__ C,
                                            int M, int N, int m0, int n0) {
  extern __shared__ float4 smem4[];
  cp_async_wait<0>();
  __syncthreads();                      // every partial of this CTA stored; smem free
  int* last = reinterpret_cast<int*>(smem4);
  if (threadIdx.x == 0)
    *last = count_in(counters + (size_t)blockIdx.y * gridDim.x + blockIdx.x, gridDim.z);
  __syncthreads();
  if (!*last) return;
  // 4 items x 4 splits in flight a thread (2 x 4 and 1 x 8 ran slower on
  // the card)
  fold_tile<4, 4>(partial, C, (size_t)M * N, gridDim.z, min(BM, M - m0), BN, N - n0,
                  (N & 3) == 0, threadIdx.x, NT,
                  [&](int r) -> long long { return (long long)(m0 + r) * N + n0; },
                  [](float v) { return v; });
}

// The bf16 build's retain GEMM on tensor cores.  Warp w owns rows
// [16 w, 16 w + 16) of the CTA tile across all BN columns (BN / 8 n8
// tiles), its fp32 sums in registers, so each A element is read, gated and
// split once per CTA.  Per R_BK chunk, two k16 steps: the B fragments by
// ldmatrix.trans from the (K x N) W ring, the A fragment by ldmatrix from
// the (M x K) ring of DW rows.  Without SE the A fragment is the bf16 DW
// values: one mma per n8 tile, exact products summed in fp32.  With SE each
// element is multiplied by the gate of its row's image (fp32 pairs, loaded
// into registers a chunk ahead), which rounds d * gate once in fp32, as the
// plain version does; that fp32 value is not a bf16 one, so it is split
// exactly into three bf16 terms (bf16x3_split2) and three mmas on the same
// B fragment add hi * w + mid * w + lo * w: each product exact in fp32,
// together exactly (d * gate) * w.  No operand is ever rounded to one bf16.
// Ragged K is zero-filled in the chunk tail (the gate too); ragged M and N
// are masked at the stores.
template <int BM, int BN, int TM, bool VEC>
__device__ __forceinline__ void retain_mma(const __nv_bfloat16* __restrict__ A,
                                           const float* __restrict__ gate,
                                           const __nv_bfloat16* __restrict__ W,
                                           float* __restrict__ partial,
                                           int* __restrict__ counters,
                                           __nv_bfloat16* __restrict__ C, int M, int K, int N,
                                           int rows_per_img, int chunks_per_split) {
  using T = __nv_bfloat16;
  using Tile = RetainTile<BM, BN, TM>;
  constexpr int NT = Tile::NT16, AP = Tile::AP16, BP = Tile::BP16, ST = R_STAGES;
  constexpr int NJ = BN / 8;            // n8 tiles per warp
  extern __shared__ float4 smem4[];
  T* a_s = reinterpret_cast<T*>(smem4);                // ST x BM x AP
  T* b_s = a_s + ST * BM * AP;                         // ST x R_BK x BP

  const int tid = threadIdx.x, lane = tid % 32, wm0 = tid / 32 * MMA_M;
  const int fr = lane / 4, fc = 2 * (lane % 4);        // fragment row, column
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_chunks = (K + R_BK - 1) / R_BK;
  const int c0 = blockIdx.z * chunks_per_split;
  const int n_loc = max(0, min(n_chunks, c0 + chunks_per_split) - c0);

  auto stage = [&](int t, int slot) {
    const int k0 = (c0 + t) * R_BK;
    T* ab = a_s + slot * BM * AP;
    T* bb = b_s + slot * R_BK * BP;
    if (VEC) {
      for (int i = tid; i < BM * (R_BK / 4); i += NT) {
        const int m = i / (R_BK / 4), j = i % (R_BK / 4);
        const int gm = m0 + m, k = k0 + 4 * j;
        const bool ok = gm < M && k < K;
        cp4(ab + m * AP + 4 * j, ok ? A + (size_t)gm * K + k : A, ok ? 4 : 0);
      }
      for (int i = tid; i < R_BK * (BN / 4); i += NT) {
        const int r = i / (BN / 4), j = i % (BN / 4);
        const int k = k0 + r, n = n0 + 4 * j;
        const bool ok = k < K && n < N;
        cp4(bb + r * BP + 4 * j, ok ? W + (size_t)k * N + n : W, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < BM * R_BK; i += NT) {
        const int m = i / R_BK, kk = i % R_BK;
        const int gm = m0 + m, k = k0 + kk;
        const bool ok = gm < M && k < K;
        cp1(ab + m * AP + kk, ok ? A + (size_t)gm * K + k : A, ok);
      }
      for (int i = tid; i < R_BK * BN; i += NT) {
        const int r = i / BN, nn = i % BN;
        const int k = k0 + r, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp1(bb + r * BP + nn, ok ? W + (size_t)k * N + n : W, ok);
      }
    }
  };

  // The gate row of the two fragment rows this lane holds (null past M or
  // without SE), and its values at the lane's fragment columns of a chunk,
  // as pairs: [h][k16 step][half], row fr + 8 h, columns fc + 8 half + {0, 1}
  // (8-byte loads where K is even, so the pair is aligned).
  const float* g_row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gm = m0 + wm0 + fr + 8 * h;
    g_row[h] = gate && gm < M ? gate + (size_t)(gm / rows_per_img) * K : nullptr;
  }
  const bool even_k = (K & 1) == 0;
  float2 g_next[2][2][2];
  auto load_gate = [&](int t) {
    const int k0 = (c0 + t) * R_BK;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int f = 0; f < 2; ++f) {
          const int k = k0 + 16 * s + 8 * f + fc;
          const float* p = g_row[h] + k;
          g_next[h][s][f] =
              !g_row[h] || k >= K ? make_float2(0.f, 0.f)
              : even_k            ? __ldg(reinterpret_cast<const float2*>(p))
                                  : make_float2(__ldg(p), k + 1 < K ? __ldg(p + 1) : 0.f);
        }
  };

  float acc[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < n_loc) stage(s, s);
    cp_async_commit();
  }
  if (gate && n_loc > 0) load_gate(0);
  for (int t = 0; t < n_loc; ++t) {
    cp_async_wait<ST - 2>();
    __syncthreads();                      // chunk t landed; slot (t - 1) % ST is free
    if (t + ST - 1 < n_loc) stage(t + ST - 1, (t + ST - 1) % ST);
    cp_async_commit();
    float2 g_cur[2][2][2];
    if (gate) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < 2; ++s)
#pragma unroll
          for (int f = 0; f < 2; ++f) g_cur[h][s][f] = g_next[h][s][f];
      if (t + 1 < n_loc) load_gate(t + 1);
    }
    const T* ab = a_s + (t % ST) * BM * AP;
    const T* bb = b_s + (t % ST) * R_BK * BP;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      unsigned af[4], bf[NJ / 2][4];      // bf[j]: n8 tiles 2 j and 2 j + 1
      ldsm_x4(af, ab + (wm0 + lane % 16) * AP + 16 * s + 8 * (lane / 16));
#pragma unroll
      for (int j = 0; j < NJ / 2; ++j)
        ldsm_x4_trans(bf[j], bb + (16 * s + lane % 16) * BP + 16 * j + 8 * (lane / 16));
      if (!gate) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[j], af, bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
        continue;
      }
      // register r: row fr + 8 (r & 1), columns fc + 8 (r >> 1) + {0, 1}
      unsigned terms[3][4];               // hi, mid, lo
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 d = unpack_bf16x2(af[r]), g = g_cur[r & 1][s][r >> 1];
        bf16x3_split2(__fmul_rn(d.x, g.x), __fmul_rn(d.y, g.y), terms[0][r], terms[1][r],
                      terms[2][r]);
      }
      // one term over every n8 tile, then the next: the products into one
      // accumulator stand NJ apart, not back to back
#pragma unroll
      for (int e = 0; e < 3; ++e)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
          mma_bf16(acc[j], terms[e], bf[j / 2][2 * (j % 2)], bf[j / 2][2 * (j % 2) + 1]);
    }
  }

  // rows fr and fr + 8 of the warp's m16 group, two neighbouring columns
  // each: fp32 partials, or C rounded once to bf16
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm0 + fr + 8 * h, n = n0 + 8 * j + fc;
      if (m >= M || n >= N) continue;
      const float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
      const size_t at = (size_t)m * N + n;
      if (partial) {
        float* p = partial + (size_t)blockIdx.z * M * N + at;
        if (pair) {
          *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
        } else {
          p[0] = v0;
          if (n + 1 < N) p[1] = v1;
        }
      } else if (pair) {
        *reinterpret_cast<__nv_bfloat162*>(C + at) = __floats2bfloat162_rn(v0, v1);
      } else {
        C[at] = __float2bfloat16_rn(v0);
        if (n + 1 < N) C[at + 1] = __float2bfloat16_rn(v1);
      }
    }
  if (partial) retain_fold<BM, BN, NT>(partial, counters, C, M, N, m0, n0);
}

// grid (ceil(N / BN), ceil(M / BM), splits).  A = dw (M, K) and W = w_proj
// (K, N) in T, gate (B, K) fp32 or null (se off); split z sums K chunks
// [z * chunks_per_split, (z + 1) * chunks_per_split) into the fp32 partial
// + z * M * N, and the last of a tile's split CTAs sums them into C
// (retain_fold); an unsplit launch (partial and counters null) writes C
// itself.  C rounds once to T.
// VEC: K and N are multiples of 4 (16-byte fp32 or 8-byte bf16 copies and
// stores).
template <int BM, int BN, int TM, bool VEC, typename T>
__global__ void __launch_bounds__(RetainTile<BM, BN, TM>::threads(sizeof(T)))
mbconv_pass2_retain_kernel(const T* __restrict__ A, const float* __restrict__ gate,
                           const T* __restrict__ W, float* __restrict__ partial,
                           int* __restrict__ counters, T* __restrict__ C, int M, int K,
                           int N, int rows_per_img, int chunks_per_split) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    retain_mma<BM, BN, TM, VEC>(A, gate, W, partial, counters, C, M, K, N, rows_per_img,
                                chunks_per_split);
    return;
  }
  using Tile = RetainTile<BM, BN, TM>;
  constexpr int NT = Tile::NT, AP = Tile::AP, ST = R_STAGES;
  extern __shared__ float4 smem4[];
  T* a_raw = reinterpret_cast<T*>(smem4);              // ST x BM x AP
  T* b_s = a_raw + ST * BM * AP;                       // ST x R_BK x BN
  float* a_t = reinterpret_cast<float*>(               // 2 x R_BK x BM (K-major)
      reinterpret_cast<char*>(smem4) + Tile::ring_bytes(sizeof(T)));

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int n_chunks = (K + R_BK - 1) / R_BK;
  const int c0 = blockIdx.z * chunks_per_split;
  const int n_loc = max(0, min(n_chunks, c0 + chunks_per_split) - c0);

  auto stage = [&](int t, int slot) {
    const int k0 = (c0 + t) * R_BK;
    T* ab = a_raw + slot * BM * AP;
    T* bb = b_s + slot * R_BK * BN;
    if (VEC) {
      for (int i = tid; i < BM * (R_BK / 4); i += NT) {
        const int m = i / (R_BK / 4), j = i % (R_BK / 4);
        const int gm = m0 + m, k = k0 + 4 * j;
        const bool ok = gm < M && k < K;
        cp4(ab + m * AP + 4 * j, ok ? A + (size_t)gm * K + k : A, ok ? 4 : 0);
      }
      for (int i = tid; i < R_BK * (BN / 4); i += NT) {
        const int r = i / (BN / 4), j = i % (BN / 4);
        const int k = k0 + r, n = n0 + 4 * j;
        const bool ok = k < K && n < N;
        cp4(bb + r * BN + 4 * j, ok ? W + (size_t)k * N + n : W, ok ? 4 : 0);
      }
    } else {
      for (int i = tid; i < BM * R_BK; i += NT) {
        const int m = i / R_BK, kk = i % R_BK;
        const int gm = m0 + m, k = k0 + kk;
        const bool ok = gm < M && k < K;
        cp1(ab + m * AP + kk, ok ? A + (size_t)gm * K + k : A, ok);
      }
      for (int i = tid; i < R_BK * BN; i += NT) {
        const int r = i / BN, nn = i % BN;
        const int k = k0 + r, n = n0 + nn;
        const bool ok = k < K && n < N;
        cp1(bb + r * BN + nn, ok ? W + (size_t)k * N + n : W, ok);
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
    const T* ab = a_raw + slot * BM * AP;
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
    const T* bb = b_s + (t % ST) * R_BK * BN + tx * 4;
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

  const int n = n0 + tx * 4;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M || n >= N) continue;
    if (partial)
      store_row(partial + (size_t)blockIdx.z * M * N + (size_t)m * N + n, acc[i], VEC, N - n);
    else
      store_row(C + (size_t)m * N + n, acc[i], VEC, N - n);
  }
  if (partial) retain_fold<BM, BN, NT>(partial, counters, C, M, N, m0, n0);
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

// The storage type of this build's C interface.
#ifdef BF16_STORAGE
using Elem = __nv_bfloat16;
#else
using Elem = float;
#endif

struct Pass1Args {
  const Elem *x, *w_exp, *w_dw;
  float *pool_partial, *pool;
  int* counters;
  Elem* dw_out;
  int identity, exp_act, dw_act;
};

struct RecomputeArgs {
  const Elem *x, *w_exp, *w_dw;
  const float* gate;
  const Elem* w_proj;
  float* partial;
  int* counters;
  Elem* out;
  int identity, exp_act, dw_act, co_tile, splits, chunks_per_split;
};

template <int K, int KS, int CMT, int NB>
cudaError_t launch_pass1_nb(const Pass1Args& a, const Geom& g, cudaStream_t stream) {
  const size_t smem = p1_smem_bytes(g.in_rows * g.in_cols, g.tile_h * g.tile_w, CMT, g.C_in,
                                    a.identity, sizeof(Elem));
  static const cudaError_t smem_set = set_max_smem(mbconv_pass1_kernel<K, KS, CMT, NB, Elem>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_mid + CMT - 1) / CMT, g.B);
  mbconv_pass1_kernel<K, KS, CMT, NB, Elem><<<grid, P1_NT, smem, stream>>>(
      a.x, a.w_exp, a.w_dw, a.pool_partial, a.pool, a.counters, a.dw_out, g, a.identity,
      a.exp_act, a.dw_act);
  return cudaGetLastError();
}

template <int K, int KS, int CMT, int NB, int TM>
cudaError_t launch_recompute_tm(const RecomputeArgs& a, const Geom& g, cudaStream_t stream) {
  const size_t smem = r2_smem_bytes(g.in_rows * g.in_cols, g.tile_h * g.tile_w, CMT, g.C_in,
                                    a.identity, a.co_tile, sizeof(Elem));
  static const cudaError_t smem_set =
      set_max_smem(mbconv_pass2_recompute_kernel<K, KS, CMT, NB, TM, Elem>);
  if (smem_set != cudaSuccess) return smem_set;
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  const dim3 grid(n_tiles(g), (g.C_out + a.co_tile - 1) / a.co_tile, g.B * a.splits);
  mbconv_pass2_recompute_kernel<K, KS, CMT, NB, TM, Elem><<<grid, P1_NT, smem, stream>>>(
      a.x, a.w_exp, a.w_dw, a.gate, a.w_proj, a.partial, a.counters, a.out, g, a.identity,
      a.exp_act, a.dw_act, a.co_tile, a.chunks_per_split);
  return cudaGetLastError();
}

// TM: R2_TM_SMALL where it covers the projection pixels per thread.
template <int K, int KS, int CMT, int NB>
cudaError_t launch_recompute_nb(const RecomputeArgs& a, const Geom& g, cudaStream_t stream) {
  if (r2_pixels_per_thread(g.tile_h * g.tile_w, a.co_tile) <= R2_TM_SMALL)
    return launch_recompute_tm<K, KS, CMT, NB, R2_TM_SMALL>(a, g, stream);
  return launch_recompute_tm<K, KS, CMT, NB, R2_TM>(a, g, stream);
}

// The c_mid tile (pass1_cm_tile), then NB, the pixel blocks an expanding
// thread holds per pass: the fewest of 1, 2 and P1_MAX_NB that cover the
// window in one pass (else P1_MAX_NB, in passes).
#define MBCONV_CM_NB_SWITCH(LAUNCH, ARGS, G, STREAM)                                   \
  {                                                                                    \
    const int q = (G).in_rows * (G).in_cols;                                           \
    if (p1_cm_tile((G).C_mid) == 64) {                                                 \
      const int nb = p1_blocks_per_thread(q, 64);                                      \
      if (nb == 1) return LAUNCH<K, KS, 64, 1>(ARGS, G, STREAM);                       \
      if (nb == 2) return LAUNCH<K, KS, 64, 2>(ARGS, G, STREAM);                       \
      return LAUNCH<K, KS, 64, P1_MAX_NB>(ARGS, G, STREAM);                            \
    }                                                                                  \
    const int nb = p1_blocks_per_thread(q, 32);                                        \
    if (nb == 1) return LAUNCH<K, KS, 32, 1>(ARGS, G, STREAM);                         \
    if (nb == 2) return LAUNCH<K, KS, 32, 2>(ARGS, G, STREAM);                         \
    return LAUNCH<K, KS, 32, P1_MAX_NB>(ARGS, G, STREAM);                              \
  }

template <int K, int KS>
cudaError_t launch_pass1(const Pass1Args& a, const Geom& g, cudaStream_t stream) {
  MBCONV_CM_NB_SWITCH(launch_pass1_nb, a, g, stream)
}

template <int K, int KS>
cudaError_t launch_recompute(const RecomputeArgs& a, const Geom& g, cudaStream_t stream) {
  MBCONV_CM_NB_SWITCH(launch_recompute_nb, a, g, stream)
}

#undef MBCONV_CM_NB_SWITCH

template <int BM, int BN, int TM, bool VEC>
cudaError_t launch_retain_tile(const Elem* dw, const float* gate, const Elem* w_proj,
                               float* partial, int* counters, Elem* out, int M, int K, int N,
                               int rows_per_img, int splits, int chunks_per_split,
                               cudaStream_t stream) {
  using Tile = RetainTile<BM, BN, TM>;
  static const cudaError_t smem_set =
      set_max_smem(mbconv_pass2_retain_kernel<BM, BN, TM, VEC, Elem>);
  if (smem_set != cudaSuccess) return smem_set;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  mbconv_pass2_retain_kernel<BM, BN, TM, VEC, Elem>
      <<<grid, Tile::threads(sizeof(Elem)), Tile::smem_bytes(sizeof(Elem)), stream>>>(
          dw, gate, w_proj, partial, counters, out, M, K, N, rows_per_img, chunks_per_split);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_retain(int bm, int bn, const Elem* dw, const float* gate, const Elem* w_proj,
                          float* partial, int* counters, Elem* out, int M, int K, int N,
                          int rows_per_img, int splits, int cps, cudaStream_t stream) {
#define RETAIN_TILE(BM_, BN_, TM_)                                                    \
  if (bm == BM_ && bn == BN_)                                                         \
    return launch_retain_tile<BM_, BN_, TM_, VEC>(dw, gate, w_proj, partial, counters, \
                                                  out, M, K, N, rows_per_img, splits, \
                                                  cps, stream);
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
// bytes of this build's storage type, and the shared memory its pass-1
// and recompute launches ask for (the schedule solver's budget checks must
// agree with them)
int mbconv_element_bytes() { return (int)sizeof(Elem); }
long long mbconv_pass1_smem_bytes(int K, int S, int tile_h, int tile_w, int C_in,
                                  int C_mid, int identity) {
  const int q = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  return (long long)p1_smem_bytes(q, tile_h * tile_w, p1_cm_tile(C_mid), C_in, identity,
                                  sizeof(Elem));
}
long long mbconv_recompute_smem_bytes(int K, int S, int tile_h, int tile_w, int C_in,
                                      int C_mid, int co_tile, int identity) {
  const int q = ((tile_h - 1) * S + K) * ((tile_w - 1) * S + K);
  return (long long)r2_smem_bytes(q, tile_h * tile_w, p1_cm_tile(C_mid), C_in, identity,
                                  co_tile, sizeof(Elem));
}
long long mbconv_retain_smem_bytes(int bm, int bn) {
  return (long long)(bm == 128 && bn == 64   ? RetainTile<128, 64, 8>::smem_bytes(sizeof(Elem))
                     : bm == 128 && bn == 32 ? RetainTile<128, 32, 4>::smem_bytes(sizeof(Elem))
                     : bn == 64              ? RetainTile<64, 64, 4>::smem_bytes(sizeof(Elem))
                                             : RetainTile<64, 32, 4>::smem_bytes(sizeof(Elem)));
}
int mbconv_retain_k_chunk() { return R_BK; }
const char* mbconv_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// x, w_exp, w_dw and dw_out in this build's storage type (Elem).
// pool_partial, pool (fp32) and counters all set (se on) or all null;
// counters holds B * ceil(C_mid / pass1_cm_tile) zeros and is left so.
int mbconv_pass1(const Elem* x, const Elem* w_exp, const Elem* w_dw,
                 float* pool_partial, float* pool, int* counters, Elem* dw_out, int B,
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

// out (B, out_h, out_w, C_out) in Elem; gate fp32 or null; for splits > 1
// the fp32 partial (splits, B, out_h, out_w, C_out) and counters holding
// n_tiles * ceil(C_out / co_tile) * B zeros (left so), else both null.
int mbconv_pass2_recompute(const Elem* x, const Elem* w_exp, const Elem* w_dw,
                           const float* gate, const Elem* w_proj, float* partial,
                           int* counters, Elem* out, int B,
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
  if ((splits > 1) != (partial != nullptr) || (splits > 1) != (counters != nullptr) || !out)
    return (int)cudaErrorInvalidValue;
  const RecomputeArgs a{x,       w_exp,   w_dw,   gate,    w_proj, partial, counters,
                        out,     identity, exp_act, dw_act, co_tile, splits, cps};
  MBCONV_KS_SWITCH(K, S, launch_recompute<KK, SS>(a, g, (cudaStream_t)stream))
}

// dw (M, K) rows of rows_per_img pixels per image and w_proj in Elem, gate
// fp32 or null, out (M, N) in Elem; for splits > 1 the fp32 partial
// (splits, M, N) and counters holding ceil(M / bm) * ceil(N / bn) zeros
// (left so), else both null.
int mbconv_pass2_retain(const Elem* dw, const float* gate, const Elem* w_proj,
                        float* partial, int* counters, Elem* out, int M, int K, int N,
                        int rows_per_img, int bm, int bn, int splits, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || rows_per_img <= 0 || splits <= 0)
    return (int)cudaErrorInvalidValue;
  if ((splits > 1) != (partial != nullptr) || (splits > 1) != (counters != nullptr) || !out)
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (K + R_BK - 1) / R_BK;
  const int cps = (n_chunks + splits - 1) / splits;
  if ((splits - 1) * cps >= n_chunks) return (int)cudaErrorInvalidValue;  // empty split
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err =
      (K % 4 == 0 && N % 4 == 0)
          ? launch_retain<true>(bm, bn, dw, gate, w_proj, partial, counters, out, M, K, N,
                                rows_per_img, splits, cps, s)
          : launch_retain<false>(bm, bn, dw, gate, w_proj, partial, counters, out, M, K, N,
                                 rows_per_img, splits, cps, s);
  return (int)err;
}

}  // extern "C"
