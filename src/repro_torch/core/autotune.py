"""Per-layer separable, MBConv and Fused-MBConv schedules for the Hopper
kernels.

Counterpart of ``repro.core.autotune``'s separable, MBConv and
Fused-MBConv solvers, handed a Hopper budget instead of the TPU one.  The
kernels (``kernels/csrc/separable.cu``, ``mbconv.cu``, ``fusedmb.cu``) tile
the output in two dimensions, ``tile_h x tile_w`` pixels, because a
full-width window does not fit a CTA's shared memory.  The solvers pick:

* for MBConv, ``tile_h`` and the ``mode`` (retain | recompute) from the
  copied traffic model (``core.perfmodel``), least bytes first, ties to
  the larger tile and then to retain, as the JAX solvers do, and
  ``tile_w`` so the staged window fits shared memory and the tile stays
  within the kernel's per-CTA pixel cap, staging the fewest input columns
  over the row (ties to the wider tile);
* for Fused-MBConv and the separable block, the tile (and for the
  separable block its C_in splits) of least modeled SM clocks
  (``fusedmb_cost``, ``fused_separable_cost``): CTAs per SM, occupancy
  from shared memory and registers, executed FMAs and, for the latency-
  bound separable blocks, per-chunk costs fitted on the card.

An MBConv block solved to retain runs its pass 2 as a GEMM with no tile,
so its tile is pass 1's alone (``pass1_tile``: occupancy and halo, not
bytes); the retain GEMM's tile and K splits come from ``retain_plan``.

The separable and Fused-MBConv blocks have no mode axis (one pass), and on
one card no family has a residency or collective axis.  Schedules are
cached in-process by family, shape and mode pin.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from .perfmodel import (
    MBCONV_MODES,
    MBConvShape,
    SeparableShape,
    fused_separable_traffic,
    fusedmb_fused_traffic,
    mbconv_fused_traffic,
    staged_separable_traffic,
)


# Budget of one H100 CTA for the kernels.  C_BLOCK is the copied traffic
# model's channel block (the JAX solvers' twin), not a kernel tile.
SMEM_BYTES = 232448                 # 227 KB dynamic smem per CTA
C_BLOCK = 32
TILE_H_CANDIDATES = (1, 2, 4, 8)

# The redesigned MBConv pass 1 and retain kernels (kernels/csrc/mbconv.cu,
# P1_* and R_BK there; the wrapper checks them against the built library).
SM_COUNT = 132                      # H100 SXM
P1_CI_CHUNK = 16                    # C_in chunk per cp.async ring slot
P1_MAX_TILE_PIXELS = 128            # pass-1 tile_h * tile_w cap
P1_PAD = 4                          # padding floats per staged pixel
P1_THREADS = 256
P1_SLOTS = 3                        # cp.async ring slots over C_in
P1_PIXEL_BLOCK = 4                  # expand pixels per register block
P1_MAX_BLOCKS = 4                   # register blocks per thread and pass
P1_CTAS_PER_SM = 3                  # resident pass-1 CTAs the planner wants
SMEM_PER_SM = 233472                # 228 KB, 1 KB of it reserved per CTA
P1_SMEM_TARGET = SMEM_PER_SM // P1_CTAS_PER_SM - 1024
RETAIN_K_CHUNK = 32                 # retain's K chunk (C_mid)
RETAIN_TILES = ((128, 64), (64, 64), (128, 32), (64, 32))   # (BM, BN)
RETAIN_MIN_CTAS = 2 * SM_COUNT      # split K below about two waves
RETAIN_MIN_SPLIT_CHUNKS = 2         # K chunks each split sums at least

# The redesigned recompute kernel (B2; kernels/csrc/mbconv.cu, R2_* there,
# checked against the built library by the wrapper): pass 1's expand and
# depthwise per c_mid chunk of pass1_cm_tile channels, then the projection
# into a c_out tile of one of RECOMPUTE_CO_TILES channels, w_proj streamed
# RECOMPUTE_K_CHUNK rows per cp.async ring slot.
MAX_TILE_PIXELS = 64                # B2's tile_h * tile_w cap
RECOMPUTE_CO_TILES = (16, 32, 64, 128)
RECOMPUTE_K_CHUNK = 16

# The redesigned Fused-MBConv kernel (kernels/csrc/fusedmb.cu; the wrapper
# checks these against the built library).  NC, one of FMB_CHUNKS, is both
# the c_mid chunk and the c_out tile; a warp lays its 32 lanes out as
# FMB_CHUNK_LANES[NC] channel lanes x the rest pixel lanes, each thread
# owning FMB_PIXELS_PER_THREAD pixels x NC / lanes channels.
FMB_MAX_TILE_PIXELS = 128           # tile_h * tile_w cap
FMB_PIXELS_PER_THREAD = 4
FMB_SLOTS = 2                       # cp.async ring slots over the weights
FMB_CHUNK_LANES = {24: 2, 32: 4, 48: 4, 64: 8}
FMB_CHUNKS = tuple(sorted(FMB_CHUNK_LANES, reverse=True))
FMB_MIN_CTAS = {24: 6, 32: 3, 48: 3, 64: 2}     # __launch_bounds__ minimum
FMB_WARPS_PER_SM = 8                # resident warps that hide the latencies
FMB_L2_FLOATS_PER_CLK = 6           # weight floats an SM streams per clock
FMB_CTA_CLOCKS = 2000               # a CTA's start: its window's load
FMB_COST_BAND = 0.15                # costs the model cannot tell apart
FMA_PER_CLK = 128                   # fp32 FMAs an SM issues per clock

# The redesigned fused-separable kernel and its split reduce
# (kernels/csrc/separable.cu; the wrapper checks these against the built
# library).  The pointwise product is the Fused-MBConv kernel's GEMM step,
# NC (one of SEP_CHUNK_LANES) its c_out tile.
SEP_MAX_TILE_PIXELS = 64            # tile_h * tile_w cap
SEP_CI_CHUNK = 32                   # C_in channels per cp.async ring slot
SEP_PIXEL_STRIDE = SEP_CI_CHUNK + 4  # padded floats per staged pixel
SEP_SLOTS = 3                       # cp.async ring slots
SEP_THREADS = 128
SEP_CHUNK_LANES = {16: 4, 24: 2, 32: 4, 48: 4, 64: 8}
SEP_MAX_CTAS_PER_SM = 4             # 128 registers per thread
SEP_CTA_CLOCKS = 250                # a CTA's start
SEP_CHUNK_CLOCKS = 300              # a chunk's barriers and loads
SEP_DW_ITEM_CLOCKS = 400            # a thread's depthwise item (9 taps)
SEP_BYTES_PER_CLK = 1900            # the card's device-memory bytes per clock


@dataclass(frozen=True)
class FusedSchedule:
    """One separable block's schedule: output tile, the c_out tile of one
    CTA, the C_in splits (partials summed by the reduce where above 1),
    modeled bytes."""

    tile_h: int
    tile_w: int
    co_tile: int
    splits: int
    total_bytes: int


@dataclass(frozen=True)
class FusedMBSchedule:
    """One Fused-MBConv block's schedule: output tile, the kernel's chunk
    (c_mid chunk and c_out tile) and c_in window chunk, modeled bytes."""

    tile_h: int
    tile_w: int
    chunk: int
    ci_chunk: int
    total_bytes: int


@dataclass(frozen=True)
class MBConvSchedule:
    """One block's schedule: output tile, pass-2 mode, modeled bytes."""

    tile_h: int
    tile_w: int
    mode: str
    total_bytes: int


def window_extent(tile: int, k: int, s: int) -> int:
    """Input rows (or columns) one ``tile``-wide output tile stages."""
    return (tile - 1) * s + k


def smem_bytes(shape: MBConvShape, tile_h: int, tile_w: int) -> int:
    """Dynamic shared memory of the recompute kernel (B2), whose tile
    pass 1 shares on recompute blocks."""
    return recompute_smem_bytes(shape.k, shape.s, tile_h, tile_w,
                                shape.c_in, shape.c_mid, shape.c_out)


def fusedmb_chunk(c_in: int, c_mid: int, c_out: int, k: int) -> int:
    """The Fused-MBConv kernel's NC (fusedmb.cu's chunk: the c_mid chunk and
    the c_out tile): of FMB_CHUNKS, the one executing the fewest FMAs per
    output pixel (``fusedmb_fmas_per_pixel``), ties to the wider chunk.  At
    EfficientNet-V2-S's widths it divides C_mid and equals C_out."""
    return min(FMB_CHUNKS, key=lambda nc: (
        _fusedmb_fmas(c_in, c_mid, c_out, k, nc), -nc))


def _fusedmb_fmas(c_in, c_mid, c_out, k, nc):
    n_co, cm = -(-c_out // nc), -(-c_mid // nc) * nc
    return n_co * cm * (k * k * -(-c_in // 4) * 4 + nc)


def fusedmb_fmas_per_pixel(c_in: int, c_mid: int, c_out: int,
                           k: int) -> int:
    """FMAs the kernel executes per output pixel: each c_out tile runs the
    conv over C_mid rounded up to the chunk and C_in rounded up to 4, and
    the chunk-wide projection of each c_mid chunk."""
    return _fusedmb_fmas(c_in, c_mid, c_out, k,
                         fusedmb_chunk(c_in, c_mid, c_out, k))


def fusedmb_threads(nc: int, pixels: int) -> int:
    """Threads of one Fused-MBConv CTA: whole warps covering the tile."""
    ppw = FMB_PIXELS_PER_THREAD * 32 // FMB_CHUNK_LANES[nc]
    return -(-pixels // ppw) * 32


def fusedmb_window_smem_bytes(in_rows: int, in_cols: int, ci_chunk: int,
                              nc: int) -> int:
    """Dynamic shared memory of one Fused-MBConv launch (fusedmb.cu's
    ``fusedmb_smem_bytes``, which the wrapper checks against this): the
    ``in_rows x in_cols`` window of ``ci_chunk`` channels (rounded up to 4
    and padded to an odd number of float4s) and FMB_SLOTS weight slots of
    max(c_in rows, NC) x NC."""
    c4 = -(-ci_chunk // 4) * 4
    stride = c4 + (8 if (c4 // 4) % 2 else 4)
    return 4 * (in_rows * in_cols * stride + FMB_SLOTS * max(c4, nc) * nc)


def fusedmb_launch_plan(c_in: int, c_mid: int, c_out: int, k: int, s: int,
                        tile_h: int, tile_w: int) -> Tuple[int, int]:
    """(NC, ci_chunk) of one Fused-MBConv launch at a tile: the window
    takes all of C_in where it fits the CTA's budget, else the widest
    multiple of 8 channels that does (the chunked fallback, which restages
    the window per chunk).  Raises where not even 8 channels fit."""
    nc = fusedmb_chunk(c_in, c_mid, c_out, k)
    rows, cols = window_extent(tile_h, k, s), window_extent(tile_w, k, s)
    for ci in [c_in] + list(range(8 * ((c_in - 1) // 8), 0, -8)):
        if fusedmb_window_smem_bytes(rows, cols, ci, nc) <= SMEM_BYTES:
            return nc, ci
    raise ValueError(f"no Fused-MBConv window fits the CTA budget: tile "
                     f"{tile_h}x{tile_w}, k {k}, s {s}, c_in {c_in}")


def fusedmb_smem_bytes(shape: MBConvShape, tile_h: int, tile_w: int) -> int:
    """Dynamic shared memory of the Fused-MBConv kernel at one tile."""
    nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                 shape.k, shape.s, tile_h, tile_w)
    return fusedmb_window_smem_bytes(
        window_extent(tile_h, shape.k, shape.s),
        window_extent(tile_w, shape.k, shape.s), ci, nc)


def fusedmb_executed_fmas(shape: MBConvShape, tile_h: int,
                          tile_w: int) -> int:
    """FMAs one Fused-MBConv launch executes: every CTA's pixel lanes
    (whole warps, ragged tiles included) times the per-pixel FMAs."""
    nc = fusedmb_chunk(shape.c_in, shape.c_mid, shape.c_out, shape.k)
    lanes = (fusedmb_threads(nc, tile_h * tile_w) // 32
             * FMB_PIXELS_PER_THREAD * 32 // FMB_CHUNK_LANES[nc])
    tiles = -(-shape.out_h // tile_h) * -(-shape.out_w // tile_w)
    return shape.b * tiles * lanes * fusedmb_fmas_per_pixel(
        shape.c_in, shape.c_mid, shape.c_out, shape.k)


def fusedmb_ctas_per_sm(nc: int, threads: int, smem: int) -> int:
    """Resident Fused-MBConv CTAs per SM: shared memory (1 KB reserved per
    CTA), threads, and the registers the launch bounds budget (at most
    65536 / (FMB_MIN_CTAS x the chunk's largest CTA) per thread)."""
    max_threads = fusedmb_threads(nc, FMB_MAX_TILE_PIXELS)
    return min(SMEM_PER_SM // (smem + 1024), 2048 // threads, 32,
               FMB_MIN_CTAS[nc] * max_threads // threads)


def fusedmb_cost(shape: MBConvShape, tile_h: int,
                 tile_w: int) -> Optional[float]:
    """Modeled SM clocks of one Fused-MBConv launch at a tile, None where
    it does not fit.  The busiest SM runs ceil(CTAs / SM_COUNT) CTAs; a CTA
    takes FMB_CTA_CLOCKS to start (its window's load) and the larger of its
    executed FMAs at FMA_PER_CLK and its streamed weights at
    FMB_L2_FLOATS_PER_CLK; an SM holding fewer than FMB_WARPS_PER_SM warps
    at once (``fusedmb_ctas_per_sm`` CTAs, or fewer where the grid gives it
    fewer) runs proportionally slower, its latencies not hidden."""
    try:
        nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                     shape.k, shape.s, tile_h, tile_w)
    except ValueError:
        return None
    threads = fusedmb_threads(nc, tile_h * tile_w)
    occ = fusedmb_ctas_per_sm(nc, threads,
                              fusedmb_smem_bytes(shape, tile_h, tile_w))
    if occ < 1:
        return None
    ctas = (-(-shape.out_h // tile_h) * -(-shape.out_w // tile_w)
            * -(-shape.c_out // nc) * shape.b)
    fmas = fusedmb_executed_fmas(shape, tile_h, tile_w) / ctas
    weights = -(-shape.c_mid // nc) * nc * (
        shape.k * shape.k * -(-ci // 4) * 4 * -(-shape.c_in // ci) + nc)
    per_cta = FMB_CTA_CLOCKS + max(fmas / FMA_PER_CLK,
                                   weights / FMB_L2_FLOATS_PER_CLK)
    per_sm = -(-ctas // SM_COUNT)
    hide = min(1.0, min(occ, per_sm) * threads / 32 / FMB_WARPS_PER_SM)
    return per_sm * per_cta / hide


def fused_separable_chunk(c_out: int, k: int) -> int:
    """The fused-separable kernel's c_out tile (separable.cu's NC): of
    SEP_CHUNK_LANES, the one doing the fewest FMAs per output pixel and
    input channel, the depthwise recomputed once per c_out tile plus the
    tile-wide pointwise (n_tiles * (k^2 + NC)); ties to the wider tile."""
    return min(SEP_CHUNK_LANES, key=lambda nc: (
        -(-c_out // nc) * (k * k + nc), -nc))


def fused_separable_window_smem_bytes(k: int, in_rows: int, in_cols: int,
                                     pixels: int, nc: int) -> int:
    """Dynamic shared memory of one fused-separable launch (separable.cu's
    ``fused_separable_smem_bytes``, which the wrapper checks against this):
    SEP_SLOTS ring slots, each the padded ``in_rows x in_cols`` window of
    one SEP_CI_CHUNK-channel chunk, its (k, k) taps and its (chunk, NC)
    pointwise rows, and two padded (pixels, chunk) depthwise tiles."""
    slot = (in_rows * in_cols * SEP_PIXEL_STRIDE + k * k * SEP_CI_CHUNK
            + SEP_CI_CHUNK * nc)
    return 4 * (SEP_SLOTS * slot + 2 * pixels * SEP_PIXEL_STRIDE)


def fused_separable_smem_bytes(shape: SeparableShape, tile_h: int,
                               tile_w: int) -> int:
    """Dynamic shared memory of the fused-separable kernel at one tile."""
    return fused_separable_window_smem_bytes(
        shape.k, window_extent(tile_h, shape.k, shape.s),
        window_extent(tile_w, shape.k, shape.s), tile_h * tile_w,
        fused_separable_chunk(shape.c_out, shape.k))


def fused_separable_split_counts(c_in: int, c_out: int) -> Tuple[int, ...]:
    """The C_in splits a fused-separable launch may take: 1, and every
    count whose splits each sum whole SEP_CI_CHUNK chunks, none empty, with
    splits * C_out < C_in, so the fp32 partials the reduce (B4') reads
    back move fewer bytes than the depthwise tensor the staged route
    writes."""
    chunks = -(-c_in // SEP_CI_CHUNK)
    return (1,) + tuple(n for n in range(2, chunks + 1)
                        if n * c_out < c_in
                        and -(-chunks // -(-chunks // n)) == n)


def fused_separable_cost(shape: SeparableShape, tile_h: int, tile_w: int,
                         splits: int) -> Optional[float]:
    """Modeled SM clocks of one fused-separable launch (and its reduce) at
    a tile and C_in split count, None where it does not fit.  At
    MobileNet-V2's widths a CTA is bound by latency: it pays SEP_CTA_CLOCKS
    to start and, per chunk it sums, SEP_CHUNK_CLOCKS of barriers and
    loads, SEP_DW_ITEM_CLOCKS per depthwise item (one pixel x 4 channels)
    each thread computes, and one clock per FMA instruction of a pointwise
    warp; the busiest SM runs ceil(CTAs / SM_COUNT) CTAs, ``occ`` of them at
    once, and never faster than its FMAs at FMA_PER_CLK.  A split adds the
    reduce: the partials read and the output written at the card's byte
    rate.  The constants are fitted to a sweep of tiles and splits over
    MobileNet-V2's 17 blocks at 224 batch 8 on the card."""
    smem = fused_separable_smem_bytes(shape, tile_h, tile_w)
    if smem > SMEM_BYTES:
        return None
    out_h, out_w = -(-shape.h // shape.s), -(-shape.w // shape.s)
    nc = fused_separable_chunk(shape.c_out, shape.k)
    ctas = (-(-out_h // tile_h) * -(-out_w // tile_w) * -(-shape.c_out // nc)
            * shape.b * splits)
    chunks = -(-(-(-shape.c_in // SEP_CI_CHUNK)) // splits)
    pixels = tile_h * tile_w
    lanes = SEP_CHUNK_LANES[nc]
    ppw = FMB_PIXELS_PER_THREAD * 32 // lanes
    pw_warps = -(-pixels // ppw)
    items = -(-pixels * SEP_CI_CHUNK // 4 // SEP_THREADS)
    per_chunk = (SEP_CHUNK_CLOCKS + SEP_DW_ITEM_CLOCKS * items
                 + SEP_CI_CHUNK * FMB_PIXELS_PER_THREAD * nc // lanes)
    per_cta = SEP_CTA_CLOCKS + chunks * per_chunk
    fmas = chunks * SEP_CI_CHUNK * (pixels * shape.k * shape.k
                                    + pw_warps * ppw * nc)
    occ = min(SMEM_PER_SM // (smem + 1024), SEP_MAX_CTAS_PER_SM)
    per_sm = -(-ctas // SM_COUNT)
    cost = max(per_sm / min(occ, per_sm) * per_cta,
               per_sm * fmas / FMA_PER_CLK)
    if splits > 1:
        cost += ((splits + 1) * 4 * shape.b * out_h * out_w * shape.c_out
                 / SEP_BYTES_PER_CLK)
    return cost


def fused_separable_launch_plan(b: int, h: int, w: int, c_in: int,
                                c_out: int, k: int, s: int, tile_h: int,
                                tile_w: int) -> Tuple[int, int]:
    """(NC, splits) of one fused-separable launch at a tile: the c_out
    tile, and the allowed split count of least ``fused_separable_cost``
    (ties to fewer splits)."""
    shape = SeparableShape(b=b, h=h, w=w, c_in=c_in, c_out=c_out, k=k, s=s)
    costs = [(fused_separable_cost(shape, tile_h, tile_w, n), n)
             for n in fused_separable_split_counts(c_in, c_out)]
    costs = [c for c in costs if c[0] is not None]
    return (fused_separable_chunk(c_out, k),
            min(costs)[1] if costs else 1)


def pass1_cm_tile(c_mid: int) -> int:
    """c_mid channels one pass-1 CTA owns (mbconv.cu's ``p1_cm_tile``): 64,
    or 32 where 64-wide tiles would pad C_mid by more than an eighth."""
    pad64 = -(-c_mid // 64) * 64 - c_mid
    return 64 if c_mid >= 64 and pad64 * 8 <= c_mid else 32


def _expand_smem_floats(k: int, s: int, tile_h: int, tile_w: int,
                        c_in: int, c_mid: int) -> Tuple[int, int]:
    """(expanded window, staging ring) floats of the expand that pass 1 and
    B2 share: the window's pixels rounded up to P1_PIXEL_BLOCK and padded,
    and P1_SLOTS ring slots (fewer where C_in has fewer chunks) of staged x
    and w_exp chunks."""
    cmt = pass1_cm_tile(c_mid)
    q4 = (-(-(window_extent(tile_h, k, s) * window_extent(tile_w, k, s))
            // P1_PIXEL_BLOCK) * P1_PIXEL_BLOCK)
    slots = min(P1_SLOTS, -(-c_in // P1_CI_CHUNK))
    return (q4 * (cmt + P1_PAD),
            slots * (q4 * (P1_CI_CHUNK + P1_PAD) + P1_CI_CHUNK * cmt))


def pass1_smem_bytes(k: int, s: int, tile_h: int, tile_w: int, c_in: int,
                     c_mid: int) -> int:
    """Dynamic shared memory of one pass-1 CTA with an expand (mbconv.cu's
    ``p1_smem_floats``; an identity expand takes no more): the expanded
    window, then one region holding the staging ring during the expand and
    the DW tile and pool rows after it."""
    cmt = pass1_cm_tile(c_mid)
    window, stage = _expand_smem_floats(k, s, tile_h, tile_w, c_in, c_mid)
    after = tile_h * tile_w * (cmt + P1_PAD) + P1_THREADS // (cmt // 4) * cmt
    return (window + max(stage, after)) * 4


def recompute_co_tile(c_out: int) -> int:
    """B2's c_out tile (mbconv.cu's ``r2_co_tile``): the narrowest of
    RECOMPUTE_CO_TILES covering C_out, else the widest."""
    return next((t for t in RECOMPUTE_CO_TILES if t >= c_out),
                RECOMPUTE_CO_TILES[-1])


def recompute_smem_bytes(k: int, s: int, tile_h: int, tile_w: int,
                         c_in: int, c_mid: int, c_out: int) -> int:
    """Dynamic shared memory of one B2 CTA with an expand (mbconv.cu's
    ``r2_smem_floats``; an identity expand takes no more): pass 1's
    expanded window, then one region holding the staging ring during the
    expand and, after it, the gated DW tile and the w_proj ring (up to
    P1_SLOTS slots of RECOMPUTE_K_CHUNK rows x the c_out tile), then the
    projection sums kept between c_mid chunks (4 floats per thread and
    pixel it owns)."""
    cmt, co = pass1_cm_tile(c_mid), recompute_co_tile(c_out)
    window, stage = _expand_smem_floats(k, s, tile_h, tile_w, c_in, c_mid)
    after = (tile_h * tile_w * (cmt + P1_PAD)
             + min(P1_SLOTS, cmt // RECOMPUTE_K_CHUNK) * RECOMPUTE_K_CHUNK
             * co)
    lanes = P1_THREADS // (co // 4)
    sums = -(-tile_h * tile_w // lanes) * P1_THREADS * 4
    return (window + max(stage, after) + sums) * 4


def pass1_single_pass(k: int, s: int, tile_h: int, tile_w: int,
                      c_mid: int) -> bool:
    """True where pass 1 expands the tile's whole window in one pass, its
    sums in registers (at most P1_MAX_BLOCKS pixel blocks per thread)."""
    lanes = P1_THREADS // (pass1_cm_tile(c_mid) // 4)
    window = window_extent(tile_h, k, s) * window_extent(tile_w, k, s)
    return window <= P1_MAX_BLOCKS * P1_PIXEL_BLOCK * lanes


def pass1_ctas(b: int, out_h: int, out_w: int, c_mid: int, tile_h: int,
               tile_w: int) -> int:
    """CTAs of one pass-1 launch: tiles x c_mid tiles x batch."""
    return (-(-out_h // tile_h) * -(-out_w // tile_w)
            * -(-c_mid // pass1_cm_tile(c_mid)) * b)


def pass1_tile(b: int, out_h: int, out_w: int, c_in: int, c_mid: int,
               k: int, s: int) -> Tuple[int, int]:
    """The pass-1 tile of a retain block.  Among tiles of at most
    P1_MAX_TILE_PIXELS whose CTA fits P1_SMEM_TARGET (P1_CTAS_PER_SM CTAs
    resident on an SM, so one CTA's staging overlaps another's arithmetic),
    whose window takes one pass and whose launch gives at least one CTA
    per SM, the one expanding the fewest window pixels over the whole map
    (the halo recompute; ties to fewer tiles, then to the taller tile).
    Where none does: the most CTAs within the target, else within the
    CTA's budget."""
    cands = []
    for th in range(1, min(out_h, P1_MAX_TILE_PIXELS) + 1):
        for tw in range(1, min(out_w, P1_MAX_TILE_PIXELS // th) + 1):
            smem = pass1_smem_bytes(k, s, th, tw, c_in, c_mid)
            if smem > SMEM_BYTES:
                continue
            n = -(-out_h // th) * -(-out_w // tw)
            expanded = n * window_extent(th, k, s) * window_extent(tw, k, s)
            cands.append((smem <= P1_SMEM_TARGET
                          and pass1_single_pass(k, s, th, tw, c_mid),
                          pass1_ctas(b, out_h, out_w, c_mid, th, tw),
                          expanded, n, -th, tw))
    if not cands:
        raise ValueError(f"no pass-1 tile fits the CTA budget: {out_h}x"
                         f"{out_w}, c_mid {c_mid}, k {k}, s {s}")
    full = [c for c in cands if c[0] and c[1] >= SM_COUNT]
    best = (min(full, key=lambda c: c[2:]) if full
            else max(cands, key=lambda c: (c[0], c[1], -c[2])))
    return -best[4], best[5]


@functools.lru_cache(maxsize=None)
def retain_plan(m: int, k: int, n: int) -> Tuple[int, int, int]:
    """(BM, BN, splits) of the retain GEMM, M = B * out_h * out_w rows,
    K = C_mid, N = C_out.  BN 32 below C_out 64, else 64; BM 128 for the
    deep GEMMs (K >= 512, M >= 1024: V2-S's late stages), whose per-thread
    8 x 4 tile reads shared memory least per product, else 64; then the
    fewest K splits that reach RETAIN_MIN_CTAS CTAs, each split summing at
    least RETAIN_MIN_SPLIT_CHUNKS K chunks (the most such splits where none
    reaches it).  Only split counts that leave no split empty are taken:
    ``splits = ceil(chunks / ceil(chunks / splits))``.  Chosen from a
    sweep of every tile and split count on the card over the B0 and V2-S
    blocks."""
    bn = 32 if n < 64 else 64
    bm = 128 if k >= 512 and m >= 1024 else 64
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // RETAIN_K_CHUNK)
    splits = 1
    for cand in range(1, max(1, chunks // RETAIN_MIN_SPLIT_CHUNKS) + 1):
        if -(-chunks // -(-chunks // cand)) != cand:
            continue            # some split would be empty
        splits = cand
        if tiles * cand >= RETAIN_MIN_CTAS:
            break
    return bm, bn, splits


@functools.lru_cache(maxsize=None)
def recompute_plan(b: int, out_h: int, out_w: int, c_mid: int, c_out: int,
                   tile_h: int, tile_w: int) -> Tuple[int, int]:
    """(c_out tile, splits) of one B2 launch: ``recompute_co_tile``, then
    the fewest C_mid splits (whole pass-1 c_mid chunks each, none empty:
    ``splits = ceil(chunks / ceil(chunks / splits))``) that give SM_COUNT
    CTAs (pixel tiles x c_out tiles x batch x splits), the most such
    splits where none does.  A split launch writes per-split partial
    projections that ``mbconv_splitk_reduce`` sums in split order."""
    co = recompute_co_tile(c_out)
    ctas = -(-out_h // tile_h) * -(-out_w // tile_w) * -(-c_out // co) * b
    chunks = -(-c_mid // pass1_cm_tile(c_mid))
    splits = 1
    for cand in range(1, chunks + 1):
        if -(-chunks // -(-chunks // cand)) != cand:
            continue            # some split would be empty
        splits = cand
        if ctas * cand >= SM_COUNT:
            break
    return co, splits


def _pick_tile_w(shape: MBConvShape, tile_h: int) -> Optional[int]:
    cap = min(shape.out_w, MAX_TILE_PIXELS // tile_h)
    fits = [tw for tw in range(1, cap + 1)
            if smem_bytes(shape, tile_h, tw) <= SMEM_BYTES]
    if not fits:
        return None
    return min(fits, key=lambda tw: (
        -(-shape.out_w // tw) * window_extent(tw, shape.k, shape.s), -tw))


def _tile_h_candidates(shape):
    return sorted({max(1, min(t, shape.out_h)) for t in TILE_H_CANDIDATES})


def select_mbconv_schedule(shape: MBConvShape,
                           mode: Optional[str] = None) -> MBConvSchedule:
    """Least modeled bytes over (tile_h, mode); ``mode`` pins the pass-2
    variant."""
    if mode is not None and mode not in MBCONV_MODES:
        raise ValueError(mode)
    modes = MBCONV_MODES if mode is None else (mode,)
    cands = []
    for th in _tile_h_candidates(shape):
        tw = _pick_tile_w(shape, th)
        if tw is None:
            continue
        for m in modes:
            total = mbconv_fused_traffic(shape, th, m, C_BLOCK).total_bytes
            cands.append(MBConvSchedule(th, tw, m, total))
    if not cands:
        raise ValueError(f"no MBConv tile fits the CTA budget: {shape}")
    best = min(cands, key=lambda c: (c.total_bytes, -c.tile_h,
                                     c.mode != "retain"))
    if best.mode != "retain":
        return best
    # retain's pass 2 is a GEMM with no tile: the tile is pass 1's alone
    th, tw = pass1_tile(shape.b, -(-shape.h // shape.s),
                        -(-shape.w // shape.s), shape.c_in, shape.c_mid,
                        shape.k, shape.s)
    return MBConvSchedule(th, tw, "retain", mbconv_fused_traffic(
        shape, th, "retain", C_BLOCK).total_bytes)


def select_fusedmb_schedule(shape: MBConvShape) -> FusedMBSchedule:
    """Among tiles of at most FMB_MAX_TILE_PIXELS whose CTAs run no idle
    pixel lane (tiles that divide the map and fill whole warps; every tile
    where none does) and whose ``fusedmb_cost`` (SM clocks: CTAs on the
    busiest SM, their start, executed FMAs, resident warps) is within
    FMB_COST_BAND of the least, the one keeping the most warps resident on
    an SM, then the largest, then the one staging the fewest window pixels
    over the map.  The band holds the tiles the model cannot tell apart;
    among them the card ran the better-occupied and then the larger tiles
    faster (fewer CTA starts and weight streams per pixel), a sweep over
    V2-S's fused blocks at 384 batch 8 shows."""
    nc = fusedmb_chunk(shape.c_in, shape.c_mid, shape.c_out, shape.k)
    exact = shape.b * shape.out_h * shape.out_w * fusedmb_fmas_per_pixel(
        shape.c_in, shape.c_mid, shape.c_out, shape.k)
    cands = []
    for th in range(1, min(shape.out_h, FMB_MAX_TILE_PIXELS) + 1):
        for tw in range(1, min(shape.out_w, FMB_MAX_TILE_PIXELS // th) + 1):
            cost = fusedmb_cost(shape, th, tw)
            if cost is None:
                continue
            threads = fusedmb_threads(nc, th * tw)
            ctas = (-(-shape.out_h // th) * -(-shape.out_w // tw)
                    * -(-shape.c_out // nc) * shape.b)
            warps = min(fusedmb_ctas_per_sm(
                nc, threads, fusedmb_smem_bytes(shape, th, tw)),
                -(-ctas // SM_COUNT)) * threads // 32
            staged = (-(-shape.out_h // th) * -(-shape.out_w // tw)
                      * window_extent(th, shape.k, shape.s)
                      * window_extent(tw, shape.k, shape.s))
            idle = fusedmb_executed_fmas(shape, th, tw) > exact
            cands.append((idle, cost, -warps, -th * tw, staged, th, tw))
    if not cands:
        raise ValueError(f"no Fused-MBConv tile fits the CTA budget: {shape}")
    idle, least = min(cands)[:2]
    th, tw = min((c for c in cands
                  if c[0] == idle and c[1] <= least * (1 + FMB_COST_BAND)),
                 key=lambda c: c[2:5])[5:]
    _, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                shape.k, shape.s, th, tw)
    return FusedMBSchedule(
        th, tw, nc, ci,
        fusedmb_fused_traffic(shape, th, C_BLOCK).total_bytes)


def select_fused_schedule(shape: SeparableShape) -> FusedSchedule:
    """The tile of least ``fused_separable_cost`` (SM clocks of the busiest
    SM, the reduce included) at its launch plan's splits, among tiles of at
    most SEP_MAX_TILE_PIXELS whose height keeps the copied traffic model's
    fused bytes below its staged bytes (the paper's per-layer claim; every
    height where none does); ties to the larger tile, then to the taller
    one.  ``total_bytes`` is the traffic model's at the tile's height."""
    out_h, out_w = -(-shape.h // shape.s), -(-shape.w // shape.s)
    cands = []
    for th in range(1, min(out_h, SEP_MAX_TILE_PIXELS) + 1):
        above = (fused_separable_traffic(shape, th).total_bytes
                 >= staged_separable_traffic(shape, th).total_bytes)
        for tw in range(1, min(out_w, SEP_MAX_TILE_PIXELS // th) + 1):
            nc, splits = fused_separable_launch_plan(
                shape.b, shape.h, shape.w, shape.c_in, shape.c_out, shape.k,
                shape.s, th, tw)
            cost = fused_separable_cost(shape, th, tw, splits)
            if cost is not None:
                cands.append((above, cost, -th * tw, -th, th, tw, nc, splits))
    if not cands:
        raise ValueError(f"no fused separable tile fits the CTA budget: "
                         f"{shape}")
    th, tw, nc, splits = min(cands)[4:]
    return FusedSchedule(th, tw, nc, splits,
                         fused_separable_traffic(shape, th).total_bytes)


_CACHE: Dict[tuple, object] = {}


def get_fused_schedule(b: int, h: int, w: int, c_in: int, c_out: int,
                       k: int, s: int, dtype_bytes: int = 4
                       ) -> FusedSchedule:
    """Cached per-layer-shape separable-block schedule lookup (the fused
    kernel's tile; the staged route takes its tile_h too)."""
    shape = SeparableShape(b=b, h=h, w=w, c_in=c_in, c_out=c_out, k=k, s=s,
                           dtype_bytes=dtype_bytes)
    key = ("separable", shape)
    if key not in _CACHE:
        _CACHE[key] = select_fused_schedule(shape)
    return _CACHE[key]


def get_mbconv_schedule(
    b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int, k: int,
    s: int, se_ratio: float = 0.25, dtype_bytes: int = 4,
    mode: Optional[str] = None,
) -> MBConvSchedule:
    """Cached per-layer-shape schedule lookup."""
    shape = MBConvShape(b=b, h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out,
                        k=k, s=s, se_ratio=se_ratio, dtype_bytes=dtype_bytes)
    key = ("mbconv", shape, mode)
    if key not in _CACHE:
        _CACHE[key] = select_mbconv_schedule(shape, mode)
    return _CACHE[key]


def get_fusedmb_schedule(
    b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int, k: int,
    s: int, dtype_bytes: int = 4,
) -> FusedMBSchedule:
    """Cached per-layer-shape Fused-MBConv schedule lookup (the shape
    carries se_ratio 0: the family never has SE)."""
    shape = MBConvShape(b=b, h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out,
                        k=k, s=s, se_ratio=0.0, dtype_bytes=dtype_bytes)
    key = ("fusedmb", shape)
    if key not in _CACHE:
        _CACHE[key] = select_fusedmb_schedule(shape)
    return _CACHE[key]
