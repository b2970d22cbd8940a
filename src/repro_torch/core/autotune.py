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
  from shared memory and registers, executed FMAs (the bf16 Fused-MBConv
  build: tensor-core products and their shared-memory fragment reads)
  and, for the latency-bound separable blocks, per-chunk costs fitted on
  the card.

An MBConv block solved to retain runs its pass 2 as a GEMM with no tile,
so its tile is pass 1's alone (``pass1_tile``: occupancy and halo, not
bytes); the retain GEMM's tile and K splits come from ``retain_plan``,
its splits capped where the byte gate's bar needs it
(``retain_split_cap``).  Shared-memory budgets count the staged rings at
the storage type's bytes (``dtype_bytes``: fp32 or bf16).

The separable and Fused-MBConv blocks have no mode axis (one pass).  On a
("data", "model") mesh (``mesh_shape``) the solvers price every candidate
with the mesh half of ``core.perfmodel`` (each device's bytes, the
collectives and any entry gather) and solve the tiles at the SHARD shape
(batch / data, the channel grid / model), because the kernels run at that
shape; the MBConv and Fused-MBConv solvers then also pick the projection's
``collective`` (ring all-reduce or reduce-scatter), and every schedule
carries its collective, its in and out layouts and its collective and
transition bytes.  At mesh (1, 1) these are the ring, replicated and 0,
and every schedule is the single-card one.

``solve_network_schedule`` is the JAX package's network layout DP over a
block chain (the stem's layout, each block's in and out layout and
collective, the boundary all-gathers), with ``_annotate_overlap`` marking
the boundaries a chain executor could pipeline.  The residency axis (the
TPU's strip-staging modes) and the persistent JSON schedule cache are not
ported: the Hopper kernels stage by one cp.async ring each, so the axis has
no second value on the card, and schedules are cached in-process by family,
shape, mesh and pins.  ``benchmark_mbconv_sweep`` times the points
``mbconv_sweep_candidates`` names on the card (the BENCH trajectory's
candidates), each checked against the oracle first.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import (
    Callable, Dict, NamedTuple, Optional, Sequence, Tuple, Union,
)

from . import telemetry
from .perfmodel import (
    COLLECTIVE_MODES,
    DEFAULT_COLLECTIVE,
    DEFAULT_LAYOUT,
    DEFAULT_OVERLAP,
    MBCONV_MODES,
    MBConvPassCosts,
    MBConvShape,
    MeshShape,
    PerfCoefficients,
    SeparableShape,
    ShardedTraffic,
    boundary_overlap_us,
    can_psum_scatter,
    can_shard_input,
    fused_separable_traffic,
    fusedmb_shard,
    layout_transition_words,
    mbconv_pass_us,
    mbconv_shard,
    separable_shard,
    shard_factors,
    sharded_fusedmb_pass_costs,
    sharded_fusedmb_traffic,
    sharded_mbconv_pass_costs,
    sharded_mbconv_traffic,
    sharded_separable_traffic,
    staged_separable_traffic,
    validate_collective,
    validate_layout,
    validate_overlap,
)


# Budget of one H100 CTA for the kernels.  C_BLOCK is the copied traffic
# model's channel block (the JAX solvers' twin), not a kernel tile.
SMEM_BYTES = 232448                 # 227 KB dynamic smem per CTA
C_BLOCK = 32
TILE_H_CANDIDATES = (1, 2, 4, 8)

# The redesigned MBConv pass 1 and retain kernels (kernels/csrc/mbconv.cu,
# P1_* and R_BK there; the wrapper checks them against the built library).
SM_COUNT = 132                      # H100 SXM
L2_BYTES = 50 * 2 ** 20             # H100's L2
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
RETAIN_STAGES = 3                   # retain's cp.async ring depth
# The bf16 build's tensor-core expand and retain GEMM (mma.sync m16n8k16):
# ring rows padded to odd multiples of 16 bytes for ldmatrix.
MMA_M = 16                          # rows of one m16n8k16 product
ROW_PAD_BF16 = 8                    # bf16 padding per w_exp / retain ring row
RETAIN_TILES = ((128, 64), (64, 64), (128, 32), (64, 32))   # (BM, BN)
RETAIN_MAX_CTAS = 2 * SM_COUNT      # a split launch's CTAs, at most
# CTAs a split retain launch runs as one wave, by storage bytes: fitted to
# the card's K split sweep of every split block of B0, V3 and V2-S
RETAIN_WAVE_CTAS = {4: SM_COUNT, 2: 2 * SM_COUNT}
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
# The bf16 build of fusedmb.cu runs both products on bf16 tensor cores
# (mma.sync m16n8k16; the wrapper checks these against the bf16 library):
# the conv walks C_mid in chunks of CM, one of FMB_BF16_MID_CHUNKS
# (``fusedmb_mid_chunk``); at CM each warp owns FMB_BF16_GROUPS[CM] m16
# row groups of the tile's pixels; a ring slot holds FMB_BF16_K16_PER_SLOT
# k16 steps of the conv's K (tap, 8-channel group); a CTA owns a c_out
# tile of one of FMB_BF16_OUT_TILES channels (NC at bf16).
FMB_BF16_MID_CHUNKS = (32, 64)
FMB_BF16_GROUPS = {32: 2, 64: 1}    # m16 row groups per warp
FMB_BF16_K16_PER_SLOT = 16          # k16 steps of w_conv per ring slot
FMB_BF16_MIN_CTAS = {32: 3, 64: 2}  # __launch_bounds__ minimum
FMB_BF16_SLOTS = 2                  # cp.async ring slots over the weights
FMB_BF16_OUT_TILES = (24, 32, 48, 64)
MMA_FMAS_PER_CLK = 1024             # bf16 products an SM's mma.sync issues per clock
SMEM_BYTES_PER_CLK = 128            # shared-memory bytes an SM reads per clock

# The redesigned fused-separable kernel, its split sum folded in
# (kernels/csrc/separable.cu; the wrapper checks these against the built
# library).  The pointwise product is the Fused-MBConv kernel's GEMM step,
# NC (one of SEP_CHUNK_LANES) its c_out tile.
SEP_MAX_TILE_PIXELS = 64            # tile_h * tile_w cap
SEP_CI_CHUNK = 32                   # C_in channels per cp.async ring slot
SEP_PIXEL_STRIDE = SEP_CI_CHUNK + 4  # padded floats per staged pixel
SEP_PIXEL_STRIDE_BF16 = SEP_CI_CHUNK + 8    # padded bf16 per staged pixel
SEP_SLOTS = 3                       # cp.async ring slots
SEP_THREADS = 128
SEP_CHUNK_LANES = {16: 4, 24: 2, 32: 4, 48: 4, 64: 8}
SEP_MAX_CTAS_PER_SM = 4             # 128 registers per thread
SEP_CTA_CLOCKS = 250                # a CTA's start
SEP_CHUNK_CLOCKS = 300              # a chunk's barriers and loads
SEP_DW_ITEM_CLOCKS = 400            # a thread's depthwise item (9 taps)
SEP_BYTES_PER_CLK = 1900            # the card's device-memory bytes per clock
# Its bf16 build (separable.cu's fused_separable_mma; the wrapper checks
# these against the built library): the pointwise on bf16 tensor cores
# (the depthwise split exactly into three bf16 terms, three mmas a B
# fragment), the depthwise in 8-channel items, and the C_in splits the CTAs
# of one thread-block cluster that sum their products in distributed
# shared memory, so no partial reaches device memory.  Four warps each own
# one m16 row group and a run of n8 tiles of the c_out tile, which is any
# multiple of 8 up to SEP_BF16_MAX_OUT_TILE (``fused_separable_out_tiles``).
SEP_BF16_MAX_OUT_TILE = 160         # widest c_out tile
SEP_BF16_OUT_TILE_COUNTS = (1, 2, 3, 4)     # c_out tiles a plan may take
SEP_BF16_MAX_SPLITS = 8             # C_in splits: the portable cluster size
SEP_BF16_TERM_STRIDE = SEP_CI_CHUNK + 8     # bf16 per depthwise-term row
SEP_BF16_MAX_CTAS_PER_SM = 3        # __launch_bounds__ minimum
SEP_BF16_GPCS = 8                   # clusters are placed within one of them
# fitted to the card's sweep (``kernel_bench --fused --measure
# --separable-splits --dtype bf16``, PERF.md section 6, PR 26)
SEP_BF16_ROUND_CLOCKS = 4400        # a round of resident clusters: start, prologue
SEP_BF16_DW_ITEM_CLOCKS = 1600      # a chunk's latency per depthwise item a thread computes
SEP_BF16_FOLD_CLOCKS = 230          # the cluster's two barriers
SEP_BF16_FOLD_ITEM_CLOCKS = 42      # a thread's fold item per rank read
SEP_BF16_DW_ISSUE_CLOCKS = 78       # an SM's issue per depthwise item of a resident CTA
SEP_BF16_MMA_ISSUE_CLOCKS = 42      # an SM's issue per mma of a resident CTA's busiest warp


@dataclass(frozen=True, kw_only=True)
class _MeshTerms:
    """What a schedule carries of its partitioning: the effective (data,
    model) factors, the projection's collective, the in and out layouts,
    and the collective and entry-gather bytes inside ``total_bytes`` (every
    device's bytes plus both).  At mesh (1, 1): the ring, replicated, 0."""

    collective: str = DEFAULT_COLLECTIVE
    in_layout: str = DEFAULT_LAYOUT
    out_layout: str = DEFAULT_LAYOUT
    collective_bytes: int = 0
    transition_bytes: int = 0
    mesh_shape: MeshShape = (1, 1)


def _mesh_terms(st: ShardedTraffic) -> dict:
    """A schedule's ``total_bytes`` and mesh terms from its pricing."""
    return dict(total_bytes=st.total_bytes, collective=st.collective,
                in_layout=st.in_layout, out_layout=st.out_layout,
                collective_bytes=st.collective_bytes,
                transition_bytes=st.transition_bytes,
                mesh_shape=st.mesh_shape)


@dataclass(frozen=True)
class FusedSchedule(_MeshTerms):
    """One separable block's schedule: output tile, the c_out tile of one
    CTA, the C_in splits (partials summed in split order where above 1),
    modeled bytes."""

    tile_h: int
    tile_w: int
    co_tile: int
    splits: int
    total_bytes: int


@dataclass(frozen=True)
class FusedMBSchedule(_MeshTerms):
    """One Fused-MBConv block's schedule: output tile, the kernel's chunk
    (c_mid chunk and c_out tile) and c_in window chunk, modeled bytes."""

    tile_h: int
    tile_w: int
    chunk: int
    ci_chunk: int
    total_bytes: int


@dataclass(frozen=True)
class MBConvSchedule(_MeshTerms):
    """One block's schedule: output tile, pass-2 mode, modeled bytes, and
    a cap on the retain GEMM's K splits (``retain_plan``'s ``max_splits``;
    None: its own count)."""

    tile_h: int
    tile_w: int
    mode: str
    total_bytes: int
    retain_splits: Optional[int] = None


Schedule = Union[MBConvSchedule, FusedMBSchedule]


class BlockRow(NamedTuple):
    """One block of a chain at its input dims: what a schedule solve
    needs (counterpart of ``repro.core.autotune.BlockRow``).  ``family``
    is "mbconv" or "fusedmb"; ``se_ratio <= 0`` means no SE."""

    h: int
    w: int
    c_in: int
    c_mid: int
    c_out: int
    k: int
    s: int
    family: str = "mbconv"
    act: str = "silu"
    se_ratio: float = 0.25


def window_extent(tile: int, k: int, s: int) -> int:
    """Input rows (or columns) one ``tile``-wide output tile stages."""
    return (tile - 1) * s + k


def smem_bytes(shape: MBConvShape, tile_h: int, tile_w: int) -> int:
    """Dynamic shared memory of the recompute kernel (B2), whose tile
    pass 1 shares on recompute blocks."""
    return recompute_smem_bytes(shape.k, shape.s, tile_h, tile_w,
                                shape.c_in, shape.c_mid, shape.c_out,
                                shape.dtype_bytes)


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


def fusedmb_out_tile(c_out: int) -> int:
    """The bf16 build's c_out tile (NC there; its c_mid chunk is
    ``fusedmb_mid_chunk``'s): of FMB_BF16_OUT_TILES, the one covering C_out
    in the fewest tiles, then with the fewest padded channels.  At
    EfficientNet-V2-S's widths it equals C_out, so the conv runs once per
    pixel."""
    return min(FMB_BF16_OUT_TILES,
               key=lambda t: (-(-c_out // t), -(-c_out // t) * t))


def fusedmb_mid_chunk(c_mid: int) -> int:
    """The bf16 build's c_mid chunk CM: of FMB_BF16_MID_CHUNKS, the one
    padding C_mid with the fewest channels, ties to the wider (24 and 96:
    32; 192 and 256: 64)."""
    return min(FMB_BF16_MID_CHUNKS,
               key=lambda cm: (-(-c_mid // cm) * cm, -cm))


def fusedmb_build_tiles(eb: int) -> Tuple[int, ...]:
    """The tiles fusedmb.cu's build for ``eb``-byte storage exports, in the
    order the wrapper reads them: (element bytes, tile pixel cap, ring
    slots, fp32 pixels per thread, fp32 channel lanes per chunk, bf16 m16
    groups per warp per c_mid chunk, bf16 k16 steps per ring slot); a
    design's fields are 0 in the other build."""
    if eb == 2:
        return (2, FMB_MAX_TILE_PIXELS, FMB_BF16_SLOTS, 0,
                dict.fromkeys(FMB_CHUNK_LANES, 0), FMB_BF16_GROUPS,
                FMB_BF16_K16_PER_SLOT)
    return (4, FMB_MAX_TILE_PIXELS, FMB_SLOTS, FMB_PIXELS_PER_THREAD,
            FMB_CHUNK_LANES, dict.fromkeys(FMB_BF16_MID_CHUNKS, 0), 0)


def _pixels_per_warp(nc: int, eb: int, cm: int) -> int:
    return (FMB_BF16_GROUPS[cm] * MMA_M if eb == 2
            else FMB_PIXELS_PER_THREAD * 32 // FMB_CHUNK_LANES[nc])


def fusedmb_threads(nc: int, pixels: int, eb: int = 4, cm: int = 0) -> int:
    """Threads of one Fused-MBConv CTA: whole warps covering the tile, at 4
    pixels per thread across the chunk's pixel lanes (fp32), or
    FMB_BF16_GROUPS[cm] m16 row groups a warp at c_mid chunk ``cm``
    (bf16)."""
    return -(-pixels // _pixels_per_warp(nc, eb, cm)) * 32


def _window_stride(ci_chunk: int, eb: int) -> int:
    """Elements per staged window pixel: fp32, the chunk rounded up to 4 and
    padded to an odd number of 4-channel groups; bf16, rounded up to 8 and
    padded to an odd multiple of 16 bytes (ldmatrix rows)."""
    if eb == 2:
        c8 = -(-ci_chunk // 8) * 8
        return c8 + (0 if (c8 // 8) % 2 else 8)
    c4 = -(-ci_chunk // 4) * 4
    return c4 + (8 if (c4 // 4) % 2 else 4)


def fusedmb_window_smem_bytes(in_rows: int, in_cols: int, ci_chunk: int,
                              nc: int, eb: int = 4, cm: int = 0) -> int:
    """Dynamic shared memory of one Fused-MBConv launch (fusedmb.cu's
    ``fusedmb_smem_bytes``, which the wrapper checks against this), all in
    the storage type (``eb`` bytes an element: the cp.async copies move
    bytes unconverted).  fp32: the ``in_rows x in_cols`` window of
    ``ci_chunk`` channels (``_window_stride``) and FMB_SLOTS weight slots of
    max(c_in rows, NC) x NC.  bf16, at c_mid chunk ``cm``: FMB_BF16_SLOTS
    ring slots of the larger of FMB_BF16_K16_PER_SLOT k16 steps of w_conv
    rows (cm + 8) and cm w_proj rows (NC rounded up to 16, + 8), the
    window, and one zero row of 8 channels."""
    window = in_rows * in_cols * _window_stride(ci_chunk, eb)
    if eb == 2:
        slot = max(FMB_BF16_K16_PER_SLOT * 16 * (cm + 8),
                   cm * (-(-nc // 16) * 16 + 8))
        return eb * (FMB_BF16_SLOTS * slot + window + 8)
    c4 = -(-ci_chunk // 4) * 4
    return eb * (window + FMB_SLOTS * max(c4, nc) * nc)


def fusedmb_launch_plan(c_in: int, c_mid: int, c_out: int, k: int, s: int,
                        tile_h: int, tile_w: int,
                        eb: int = 4) -> Tuple[int, int]:
    """(NC, ci_chunk) of one Fused-MBConv launch at a tile: NC is
    ``fusedmb_chunk`` (fp32) or ``fusedmb_out_tile`` (bf16, at c_mid chunk
    ``fusedmb_mid_chunk``); the window takes all of C_in where it fits the
    CTA's budget, else the widest multiple of 8 channels that does (the
    chunked fallback, which restages the window per chunk).  Raises where
    not even 8 channels fit."""
    nc = (fusedmb_out_tile(c_out) if eb == 2
          else fusedmb_chunk(c_in, c_mid, c_out, k))
    cm = fusedmb_mid_chunk(c_mid) if eb == 2 else 0
    rows, cols = window_extent(tile_h, k, s), window_extent(tile_w, k, s)
    for ci in [c_in] + list(range(8 * ((c_in - 1) // 8), 0, -8)):
        if fusedmb_window_smem_bytes(rows, cols, ci, nc, eb, cm) <= SMEM_BYTES:
            return nc, ci
    raise ValueError(f"no Fused-MBConv window fits the CTA budget: tile "
                     f"{tile_h}x{tile_w}, k {k}, s {s}, c_in {c_in}")


def fusedmb_smem_bytes(shape: MBConvShape, tile_h: int, tile_w: int) -> int:
    """Dynamic shared memory of the Fused-MBConv kernel at one tile."""
    eb = shape.dtype_bytes
    nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                 shape.k, shape.s, tile_h, tile_w, eb)
    return fusedmb_window_smem_bytes(
        window_extent(tile_h, shape.k, shape.s),
        window_extent(tile_w, shape.k, shape.s), ci, nc, eb,
        fusedmb_mid_chunk(shape.c_mid) if eb == 2 else 0)


def fusedmb_k16_steps(c_in: int, k: int, ci: int) -> Tuple[int, ...]:
    """The bf16 conv's k16 steps per c_in chunk of ``ci`` channels: the
    chunk's (tap, 8-channel group) pairs, two a step, the tail padded."""
    return tuple(-(-k * k * -(-min(ci, c_in - c0) // 8) // 2)
                 for c0 in range(0, c_in, ci))


def fusedmb_products_per_pixel(shape: MBConvShape, ci: int) -> int:
    """bf16: tensor-core products (FMAs) the kernel executes per output
    pixel row at C_in window chunk ``ci``: each c_out tile runs the conv
    over C_mid rounded up to the c_mid chunk and its k16 steps of 16, and
    the projection at three products (the exact split) per c_mid channel
    and c_out tile channel."""
    nc = fusedmb_out_tile(shape.c_out)
    chunk = fusedmb_mid_chunk(shape.c_mid)
    cm = -(-shape.c_mid // chunk) * chunk
    k16 = sum(fusedmb_k16_steps(shape.c_in, shape.k, ci))
    return -(-shape.c_out // nc) * cm * (16 * k16 + 3 * nc)


def fusedmb_executed_pixels(shape: MBConvShape, tile_h: int,
                            tile_w: int) -> int:
    """Pixel rows one Fused-MBConv launch computes: every CTA's pixel lanes
    (fp32) or m16 rows (bf16), whole warps, ragged tiles included."""
    eb = shape.dtype_bytes
    nc = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out, shape.k,
                             shape.s, tile_h, tile_w, eb)[0]
    cm = fusedmb_mid_chunk(shape.c_mid) if eb == 2 else 0
    threads = fusedmb_threads(nc, tile_h * tile_w, eb, cm)
    tiles = -(-shape.out_h // tile_h) * -(-shape.out_w // tile_w)
    return (shape.b * tiles * threads // 32
            * _pixels_per_warp(nc, eb, cm))


def fusedmb_executed_fmas(shape: MBConvShape, tile_h: int,
                          tile_w: int) -> int:
    """FMAs one Fused-MBConv launch executes: every CTA's pixel lanes
    (whole warps, ragged tiles included) times the per-pixel FMAs (fp32),
    or its m16 rows times ``fusedmb_products_per_pixel`` (bf16)."""
    rows = fusedmb_executed_pixels(shape, tile_h, tile_w)
    if shape.dtype_bytes == 2:
        ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                 shape.k, shape.s, tile_h, tile_w, 2)[1]
        return rows * fusedmb_products_per_pixel(shape, ci)
    return rows * fusedmb_fmas_per_pixel(shape.c_in, shape.c_mid,
                                         shape.c_out, shape.k)


def fusedmb_ctas_per_sm(nc: int, threads: int, smem: int,
                        eb: int = 4, cm: int = 0) -> int:
    """Resident Fused-MBConv CTAs per SM: shared memory (1 KB reserved per
    CTA), threads, and the registers the launch bounds budget (at most
    65536 / (the minimum CTAs x the largest CTA) per thread)."""
    max_threads = fusedmb_threads(nc, FMB_MAX_TILE_PIXELS, eb, cm)
    min_ctas = FMB_BF16_MIN_CTAS[cm] if eb == 2 else FMB_MIN_CTAS[nc]
    return min(SMEM_PER_SM // (smem + 1024), 2048 // threads, 32,
               min_ctas * max_threads // threads)


def _fusedmb_smem_reads(shape: MBConvShape, nc: int, ci: int,
                        warps: int) -> int:
    """bf16: shared-memory bytes one CTA's warps read as fragments (512 a
    ldmatrix.x4): per k16 step of each c_mid chunk an A fragment per m16
    group and the chunk's B fragments, then the projection's B fragments."""
    cm = fusedmb_mid_chunk(shape.c_mid)
    n_cm = -(-shape.c_mid // cm)
    k16 = sum(fusedmb_k16_steps(shape.c_in, shape.k, ci))
    loads = n_cm * (k16 * (FMB_BF16_GROUPS[cm] + cm // 16)
                    + cm // 16 * -(-nc // 16))
    return warps * loads * 512


def fusedmb_cost(shape: MBConvShape, tile_h: int,
                 tile_w: int) -> Optional[float]:
    """Modeled SM clocks of one Fused-MBConv launch at a tile, None where
    it does not fit.  The busiest SM runs ceil(CTAs / SM_COUNT) CTAs; a CTA
    takes FMB_CTA_CLOCKS to start (its window's load) and the larger of its
    executed products (fp32: FMAs at FMA_PER_CLK; bf16: tensor-core
    products at MMA_FMAS_PER_CLK, or their fragments' shared-memory reads
    at SMEM_BYTES_PER_CLK, whichever is slower) and its streamed weights
    at FMB_L2_FLOATS_PER_CLK x 4 bytes; an SM holding fewer than
    FMB_WARPS_PER_SM warps at once (``fusedmb_ctas_per_sm`` CTAs, or fewer
    where the grid gives it fewer) runs proportionally slower, its
    latencies not hidden."""
    eb = shape.dtype_bytes
    try:
        nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                     shape.k, shape.s, tile_h, tile_w, eb)
    except ValueError:
        return None
    cm = fusedmb_mid_chunk(shape.c_mid) if eb == 2 else 0
    threads = fusedmb_threads(nc, tile_h * tile_w, eb, cm)
    occ = fusedmb_ctas_per_sm(nc, threads,
                              fusedmb_smem_bytes(shape, tile_h, tile_w), eb,
                              cm)
    if occ < 1:
        return None
    ctas = (-(-shape.out_h // tile_h) * -(-shape.out_w // tile_w)
            * -(-shape.c_out // nc) * shape.b)
    fmas = fusedmb_executed_fmas(shape, tile_h, tile_w) / ctas
    if eb == 2:
        weights = (shape.k ** 2 * shape.c_in * shape.c_mid
                   + shape.c_mid * nc) * eb / 4
        ops = max(fmas / MMA_FMAS_PER_CLK,
                  _fusedmb_smem_reads(shape, nc, ci, threads // 32)
                  / SMEM_BYTES_PER_CLK)
    else:
        weights = -(-shape.c_mid // nc) * nc * (
            shape.k * shape.k * -(-ci // 4) * 4 * -(-shape.c_in // ci) + nc)
        ops = fmas / FMA_PER_CLK
    per_cta = FMB_CTA_CLOCKS + max(ops, weights / FMB_L2_FLOATS_PER_CLK)
    per_sm = -(-ctas // SM_COUNT)
    hide = min(1.0, min(occ, per_sm) * threads / 32 / FMB_WARPS_PER_SM)
    return per_sm * per_cta / hide


def fused_separable_chunk(c_out: int, k: int) -> int:
    """The fp32 fused-separable kernel's c_out tile (separable.cu's NC): of
    SEP_CHUNK_LANES, the one doing the fewest FMAs per output pixel and
    input channel, the depthwise recomputed once per c_out tile plus the
    tile-wide pointwise (n_tiles * (k^2 + NC)); ties to the wider tile."""
    return min(SEP_CHUNK_LANES, key=lambda nc: (
        -(-c_out // nc) * (k * k + nc), -nc))


def fused_separable_out_tiles(c_out: int, k: int, eb: int = 4
                              ) -> Tuple[int, ...]:
    """The c_out tiles a fused-separable launch may take at ``eb``-byte
    storage: fp32 ``fused_separable_chunk``'s one; bf16, for each count of
    SEP_BF16_OUT_TILE_COUNTS, the narrowest multiple of 8 (at least 16)
    that covers C_out in that many tiles, where at most
    SEP_BF16_MAX_OUT_TILE (the whole C_out up to 160, then 2, 3 or 4 tiles:
    the depthwise is recomputed once per tile), widest first."""
    if eb == 4:
        return (fused_separable_chunk(c_out, k),)
    tiles = {max(16, 8 * -(-c_out // (8 * n)))
             for n in SEP_BF16_OUT_TILE_COUNTS}
    return tuple(sorted((nc for nc in tiles
                         if nc <= SEP_BF16_MAX_OUT_TILE
                         and -(-c_out // nc) in SEP_BF16_OUT_TILE_COUNTS),
                        reverse=True))


def fused_separable_pixel_stride(eb: int = 4) -> int:
    """Elements of the storage type per staged window pixel (separable.cu's
    ``x_stride``): fp32 SEP_PIXEL_STRIDE floats, bf16 SEP_PIXEL_STRIDE_BF16
    (80 bytes, an odd number of 16-byte units)."""
    return SEP_PIXEL_STRIDE if eb == 4 else SEP_PIXEL_STRIDE_BF16


def fused_separable_col_warps(pixels: int) -> int:
    """Warps of the bf16 build sharing one m16 row group across the c_out
    tile (separable.cu's ``mma_col_warps``): 4 at up to 16 pixels, 2 at up
    to 32, else 1 (each of the 4 warps its own group)."""
    return 4 if pixels <= 16 else 2 if pixels <= 32 else 1


def fused_separable_window_smem_bytes(k: int, in_rows: int, in_cols: int,
                                     pixels: int, nc: int,
                                     eb: int = 4) -> int:
    """Dynamic shared memory of one fused-separable launch at ``eb``-byte
    storage (separable.cu's ``fused_separable_smem_bytes``, which the
    wrapper checks against this): SEP_SLOTS ring slots in the storage
    type, each the padded ``in_rows x in_cols`` window of one
    SEP_CI_CHUNK-channel chunk, its (k, k) taps and its (chunk, NC)
    pointwise rows; then in fp32 two padded fp32 (pixels, chunk) depthwise
    tiles; in bf16 (rows padded to an odd number of 16-byte units) two sets
    of the three bf16 (pixels, SEP_BF16_TERM_STRIDE) depthwise terms, or,
    where larger, the fp32 (pixels, NC + 4) product tile the cluster's fold
    reads in the same bytes."""
    if eb == 4:
        slot = (in_rows * in_cols * SEP_PIXEL_STRIDE + k * k * SEP_CI_CHUNK
                + SEP_CI_CHUNK * nc)
        return 4 * SEP_SLOTS * slot + 4 * 2 * pixels * SEP_PIXEL_STRIDE
    row = nc if (nc // 8) % 2 else nc + 8
    slot = (in_rows * in_cols * SEP_PIXEL_STRIDE_BF16 + k * k * SEP_CI_CHUNK
            + SEP_CI_CHUNK * row)
    ring = 2 * SEP_SLOTS * slot + 2 * 2 * 3 * pixels * SEP_BF16_TERM_STRIDE
    return max(ring, 4 * pixels * (nc + 4))


def fused_separable_smem_bytes(shape: SeparableShape, tile_h: int,
                               tile_w: int, nc: Optional[int] = None) -> int:
    """Dynamic shared memory of the fused-separable kernel at one tile and
    c_out tile (the launch plan's by default)."""
    if nc is None:
        nc = fused_separable_launch_plan(
            shape.b, shape.h, shape.w, shape.c_in, shape.c_out, shape.k,
            shape.s, tile_h, tile_w, shape.dtype_bytes)[0]
    return fused_separable_window_smem_bytes(
        shape.k, window_extent(tile_h, shape.k, shape.s),
        window_extent(tile_w, shape.k, shape.s), tile_h * tile_w, nc,
        shape.dtype_bytes)


def fused_separable_split_counts(c_in: int, c_out: int,
                                 eb: int = 4) -> Tuple[int, ...]:
    """The C_in splits a fused-separable launch may take at ``eb``-byte
    storage: 1, and every count whose splits each sum whole SEP_CI_CHUNK
    chunks, none empty; in fp32 with 4 * splits * C_out < 4 * C_in, so the
    fp32 partials the split sum (B4') reads back move fewer bytes than the
    depthwise tensor the staged route writes; in bf16 up to
    SEP_BF16_MAX_SPLITS (a cluster's CTAs), with no byte bar, since no
    partial leaves the SMs."""
    chunks = -(-c_in // SEP_CI_CHUNK)
    top = chunks if eb == 4 else min(chunks, SEP_BF16_MAX_SPLITS)
    return (1,) + tuple(n for n in range(2, top + 1)
                        if (eb == 2 or 4 * n * c_out < eb * c_in)
                        and -(-chunks // -(-chunks // n)) == n)


def fused_separable_cost(shape: SeparableShape, tile_h: int, tile_w: int,
                         splits: int, nc: Optional[int] = None
                         ) -> Optional[float]:
    """Modeled SM clocks of one fused-separable launch (its split sum in) at
    a tile, C_in split count and (bf16) c_out tile, None where it does not
    fit.  At MobileNet-V2's widths a CTA is bound by latency: it pays
    SEP_CTA_CLOCKS to start and, per chunk it sums, SEP_CHUNK_CLOCKS of
    barriers and loads, SEP_DW_ITEM_CLOCKS per depthwise item (one pixel x
    4 channels) each thread computes, and one clock per FMA instruction of a
    pointwise warp; the busiest SM runs ceil(CTAs / SM_COUNT) CTAs, ``occ``
    of them at once, and never faster than its FMAs at FMA_PER_CLK.  A
    split adds its split sum (B4', folded into the launch's last CTAs): the
    partials read back and the output written at the card's byte rate.  The
    constants are fitted to a sweep of tiles and splits over MobileNet-V2's
    17 blocks at 224 batch 8 on the card; with the sum folded in, the card's
    sweep of every split count (``kernel_bench --fused --measure
    --separable-splits``) times the launch plan's pick fastest on every
    fp32 block that may split, so the term stands.  bf16 storage is
    ``_fused_separable_cost_bf16``'s."""
    if shape.dtype_bytes == 2:
        return _fused_separable_cost_bf16(shape, tile_h, tile_w, splits, nc)
    smem = fused_separable_smem_bytes(
        shape, tile_h, tile_w, fused_separable_chunk(shape.c_out, shape.k))
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


def _fused_separable_cost_bf16(shape: SeparableShape, tile_h: int,
                               tile_w: int, splits: int,
                               nc: Optional[int]) -> Optional[float]:
    """Modeled SM clocks of one bf16 fused-separable launch (the tensor-core
    pointwise, its C_in splits a cluster) at a tile, split count and c_out
    tile (the widest of ``fused_separable_out_tiles`` by default), None
    where it does not fit.  ``occ`` CTAs share an SM, and a cluster's CTAs
    sit in one of SEP_BF16_GPCS GPCs, so the card holds SEP_BF16_GPCS x
    (SMs a GPC x occ // splits) clusters at once: the launch takes as many
    rounds as it has clusters per that.  A round costs the latency of one
    CTA: SEP_BF16_ROUND_CLOCKS, SEP_BF16_DW_ITEM_CLOCKS a chunk per
    depthwise item (one pixel x 8 channels) a thread computes, and for a
    split launch the cluster's fold (SEP_BF16_FOLD_CLOCKS and
    SEP_BF16_FOLD_ITEM_CLOCKS per rank read of each fold item a thread
    sums).  On top, the busiest SM issues, for each CTA it runs, per chunk
    SEP_BF16_DW_ISSUE_CLOCKS per depthwise item and
    SEP_BF16_MMA_ISSUE_CLOCKS per mma of its busiest warp (2 k16 steps x 3
    terms x its n8 tiles).  Never faster than the compulsory bytes (x, the
    weights and the output at 2 bytes) at SEP_BYTES_PER_CLK.  Fitted to the
    card's sweep of tiles, c_out tiles and cluster sizes over
    MobileNet-V2's 17 blocks at 224 batch 8."""
    if nc is None:
        nc = fused_separable_out_tiles(shape.c_out, shape.k, 2)[0]
    pixels = tile_h * tile_w
    smem = fused_separable_smem_bytes(shape, tile_h, tile_w, nc)
    if smem > SMEM_BYTES or pixels > SEP_MAX_TILE_PIXELS:
        return None
    out_h, out_w = -(-shape.h // shape.s), -(-shape.w // shape.s)
    clusters = (-(-out_h // tile_h) * -(-out_w // tile_w)
                * -(-shape.c_out // nc) * shape.b)
    chunks = -(-(-(-shape.c_in // SEP_CI_CHUNK)) // splits)
    mmas = 2 * 3 * -(-(nc // 8) // fused_separable_col_warps(pixels))
    items = -(-pixels * SEP_CI_CHUNK // 8 // SEP_THREADS)
    latency = SEP_BF16_ROUND_CLOCKS + chunks * SEP_BF16_DW_ITEM_CLOCKS * items
    if splits > 1:
        fold_items = -(-(-(-pixels // splits)) * -(-nc // 4) // SEP_THREADS)
        latency += (SEP_BF16_FOLD_CLOCKS
                    + SEP_BF16_FOLD_ITEM_CLOCKS * fold_items * splits)
    occ = min(SMEM_PER_SM // (smem + 1024), SEP_BF16_MAX_CTAS_PER_SM)
    slots = SEP_BF16_GPCS * (SM_COUNT // SEP_BF16_GPCS * occ // splits)
    if slots == 0:
        return None
    per_sm = -(-clusters * splits // SM_COUNT)
    issue = per_sm * chunks * (SEP_BF16_DW_ISSUE_CLOCKS * items
                               + SEP_BF16_MMA_ISSUE_CLOCKS * mmas)
    compulsory = 2 * (shape.b * (shape.h * shape.w * shape.c_in
                                 + out_h * out_w * shape.c_out)
                      + shape.c_in * (shape.k ** 2 + shape.c_out))
    return max(-(-clusters // slots) * latency + issue,
               compulsory / SEP_BYTES_PER_CLK)


@functools.lru_cache(maxsize=None)
def fused_separable_launch_plan(b: int, h: int, w: int, c_in: int,
                                c_out: int, k: int, s: int, tile_h: int,
                                tile_w: int, eb: int = 4) -> Tuple[int, int]:
    """(NC, splits) of one fused-separable launch at a tile and
    ``eb``-byte storage: of the c_out tiles (``fused_separable_out_tiles``)
    and allowed split counts, the pair of least ``fused_separable_cost``
    (ties to fewer splits, then to the wider tile); cached, as every
    launch asks for it."""
    shape = SeparableShape(b=b, h=h, w=w, c_in=c_in, c_out=c_out, k=k, s=s,
                           dtype_bytes=eb)
    tiles = fused_separable_out_tiles(c_out, k, eb)
    costs = [(fused_separable_cost(shape, tile_h, tile_w, n, nc), n, -nc)
             for nc in tiles
             for n in fused_separable_split_counts(c_in, c_out, eb)]
    costs = [c for c in costs if c[0] is not None]
    if not costs:
        return tiles[0], 1
    _, splits, nc = min(costs)
    return -nc, splits


def pass1_cm_tile(c_mid: int) -> int:
    """c_mid channels one pass-1 CTA owns (mbconv.cu's ``p1_cm_tile``): 64,
    or 32 where 64-wide tiles would pad C_mid by more than an eighth."""
    pad64 = -(-c_mid // 64) * 64 - c_mid
    return 64 if c_mid >= 64 and pad64 * 8 <= c_mid else 32


def _expand_smem_floats(k: int, s: int, tile_h: int, tile_w: int,
                        c_in: int, c_mid: int, eb: int = 4
                        ) -> Tuple[int, int]:
    """(expanded window floats, staging ring elements) of the expand that
    pass 1 and B2 share at ``eb``-byte storage (mbconv.cu's
    ``p1_window_floats`` and ``p1_stage_bytes``): the fp32 window's pixels
    rounded up to P1_PIXEL_BLOCK and padded, and P1_SLOTS ring slots (fewer
    where C_in has fewer chunks) of staged x and w_exp chunks in the
    storage type.  fp32 stages each pixel at P1_CI_CHUNK + P1_PAD floats and
    w_exp rows of the c_mid tile; the bf16 tensor-core expand stages the
    window rounded up to whole MMA_M row groups at P1_CI_CHUNK elements a
    pixel (swizzled, unpadded) and w_exp rows padded by ROW_PAD_BF16."""
    cmt = pass1_cm_tile(c_mid)
    q = window_extent(tile_h, k, s) * window_extent(tile_w, k, s)
    q4 = -(-q // P1_PIXEL_BLOCK) * P1_PIXEL_BLOCK
    slots = min(P1_SLOTS, -(-c_in // P1_CI_CHUNK))
    if eb == 2:
        ring = (-(-q // MMA_M) * MMA_M * P1_CI_CHUNK
                + P1_CI_CHUNK * (cmt + ROW_PAD_BF16))
    else:
        ring = q4 * (P1_CI_CHUNK + P1_PAD) + P1_CI_CHUNK * cmt
    return q4 * (cmt + P1_PAD), slots * ring


def pass1_smem_bytes(k: int, s: int, tile_h: int, tile_w: int, c_in: int,
                     c_mid: int, eb: int = 4) -> int:
    """Dynamic shared memory of one pass-1 CTA with an expand (mbconv.cu's
    ``p1_smem_bytes``; an identity expand takes no more) at ``eb``-byte
    storage: the fp32 expanded window, then one region holding the
    staging ring during the expand and the fp32 DW tile and pool rows
    after it."""
    cmt = pass1_cm_tile(c_mid)
    window, stage = _expand_smem_floats(k, s, tile_h, tile_w, c_in, c_mid,
                                        eb)
    after = tile_h * tile_w * (cmt + P1_PAD) + P1_THREADS // (cmt // 4) * cmt
    return window * 4 + max(stage * eb, after * 4)


def recompute_co_tile(c_out: int) -> int:
    """B2's c_out tile (mbconv.cu's ``r2_co_tile``): the narrowest of
    RECOMPUTE_CO_TILES covering C_out, else the widest."""
    return next((t for t in RECOMPUTE_CO_TILES if t >= c_out),
                RECOMPUTE_CO_TILES[-1])


def recompute_smem_bytes(k: int, s: int, tile_h: int, tile_w: int,
                         c_in: int, c_mid: int, c_out: int,
                         eb: int = 4) -> int:
    """Dynamic shared memory of one B2 CTA with an expand (mbconv.cu's
    ``r2_smem_bytes``; an identity expand takes no more) at ``eb``-byte
    storage: pass 1's expanded window, then one region holding the
    staging ring during the expand and, after it, the fp32 gated DW tile
    and the w_proj ring (up to P1_SLOTS slots of RECOMPUTE_K_CHUNK rows x
    the c_out tile, in the storage type), then the projection sums kept
    between c_mid chunks (4 floats per thread and pixel it owns)."""
    cmt, co = pass1_cm_tile(c_mid), recompute_co_tile(c_out)
    window, stage = _expand_smem_floats(k, s, tile_h, tile_w, c_in, c_mid,
                                        eb)
    after = (tile_h * tile_w * (cmt + P1_PAD) * 4
             + min(P1_SLOTS, cmt // RECOMPUTE_K_CHUNK) * RECOMPUTE_K_CHUNK
             * co * eb)
    lanes = P1_THREADS // (co // 4)
    sums = -(-tile_h * tile_w // lanes) * P1_THREADS * 4
    return window * 4 + max(stage * eb, after) + sums * 4


def pass1_single_pass(k: int, s: int, tile_h: int, tile_w: int,
                      c_mid: int) -> bool:
    """True where pass 1 expands the tile's whole window in one pass, its
    sums in registers (at most P1_MAX_BLOCKS pixel blocks per thread; the
    bf16 tensor-core expand's m16 row groups cover the same pixels)."""
    lanes = P1_THREADS // (pass1_cm_tile(c_mid) // 4)
    window = window_extent(tile_h, k, s) * window_extent(tile_w, k, s)
    return window <= P1_MAX_BLOCKS * P1_PIXEL_BLOCK * lanes


def pass1_ctas(b: int, out_h: int, out_w: int, c_mid: int, tile_h: int,
               tile_w: int) -> int:
    """CTAs of one pass-1 launch: tiles x c_mid tiles x batch."""
    return (-(-out_h // tile_h) * -(-out_w // tile_w)
            * -(-c_mid // pass1_cm_tile(c_mid)) * b)


def pass1_tile(b: int, out_h: int, out_w: int, c_in: int, c_mid: int,
               k: int, s: int, eb: int = 4) -> Tuple[int, int]:
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
            smem = pass1_smem_bytes(k, s, th, tw, c_in, c_mid, eb)
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


def retain_smem_bytes(bm: int, bn: int, eb: int = 4) -> int:
    """Dynamic shared memory of one retain GEMM CTA (mbconv.cu's
    ``RetainTile``): RETAIN_STAGES ring slots of the (BM, K chunk) A tile
    and the (K chunk, BN) B tile in the storage type (``eb`` bytes).  fp32:
    A rows padded by 4, and two fp32 K-major copies of the A tile; bf16
    (tensor cores, fragments by ldmatrix): A and B rows padded by
    ROW_PAD_BF16, no copies."""
    k = RETAIN_K_CHUNK
    if eb == 2:
        return eb * RETAIN_STAGES * (bm * (k + ROW_PAD_BF16)
                                     + k * (bn + ROW_PAD_BF16))
    return (eb * (RETAIN_STAGES * bm * (k + 4) + RETAIN_STAGES * k * bn)
            + 4 * 2 * k * bm)


def retain_split_choices(k: int) -> Tuple[int, ...]:
    """The K split counts the retain GEMM may take at K = ``k``: 1, and
    every count that leaves no split empty (``splits = ceil(chunks /
    ceil(chunks / splits))``) with each split summing at least
    RETAIN_MIN_SPLIT_CHUNKS K chunks."""
    chunks = -(-k // RETAIN_K_CHUNK)
    top = max(1, chunks // RETAIN_MIN_SPLIT_CHUNKS)
    return tuple(n for n in range(1, top + 1)
                 if -(-chunks // -(-chunks // n)) == n)


@functools.lru_cache(maxsize=None)
def retain_plan(m: int, k: int, n: int, max_splits: Optional[int] = None,
                eb: int = 4) -> Tuple[int, int, int]:
    """(BM, BN, splits) of the retain GEMM at ``eb``-byte storage, M = B *
    out_h * out_w rows, K = C_mid, N = C_out.  BN 32 below C_out 64, else
    64; BM 128 for the deep GEMMs (K >= 512, M >= 1024: V2-S's late
    stages), whose per-thread 8 x 4 tile reads shared memory least per
    product, else 64.  Then, of the K split counts the GEMM may take
    (``retain_split_choices``, at most ``max_splits``) whose CTAs (tiles x
    splits) stay within RETAIN_MAX_CTAS (up to two splits always may), the
    one whose busiest SM sums the fewest K chunks: ceil(CTAs /
    RETAIN_WAVE_CTAS[eb]) waves x ceil(chunks / splits) chunks a CTA; ties
    to more splits.  Each split launch's last CTA per output tile reads
    every split's partial (the fold's tail), which the cap bounds.  Fitted
    to the card's sweep of every split count on every split block of B0,
    V3 and V2-S in fp32 and bf16 (``kernel_bench --fused --measure
    --block``)."""
    bn = 32 if n < 64 else 64
    bm = 128 if k >= 512 and m >= 1024 else 64
    tiles = -(-m // bm) * -(-n // bn)
    chunks = -(-k // RETAIN_K_CHUNK)
    wave = RETAIN_WAVE_CTAS[eb]
    cands = [s for s in retain_split_choices(k)
             if s <= (max_splits or s)
             and (s <= 2 or tiles * s <= RETAIN_MAX_CTAS)]
    splits = min(cands, key=lambda s: (
        -(-tiles * s // wave) * -(-chunks // s), -s))
    return bm, bn, splits


@functools.lru_cache(maxsize=None)
def recompute_plan(b: int, out_h: int, out_w: int, c_mid: int, c_out: int,
                   tile_h: int, tile_w: int) -> Tuple[int, int]:
    """(c_out tile, splits) of one B2 launch: ``recompute_co_tile``, then
    the fewest C_mid splits (whole pass-1 c_mid chunks each, none empty:
    ``splits = ceil(chunks / ceil(chunks / splits))``) that give SM_COUNT
    CTAs (pixel tiles x c_out tiles x batch x splits), the most such
    splits where none does.  A split launch writes per-split partial
    projections that its last CTA per output tile sums in split order."""
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


# Ties between byte-equal collectives go to the ring: its output is
# replicated, which any consumer takes.
_COLLECTIVE_RANK = {"ring_allreduce": 0, "psum_scatter": 1}


def _collective_set(shape: MBConvShape, eff: MeshShape,
                    collective: Optional[str]) -> Tuple[str, ...]:
    """Collectives the solver may price at this partitioning: the ring
    alone off the model axis (nothing crosses devices, a pin is ignored),
    else the pin, else both (a c_out the factor does not divide pads)."""
    _dp, mp = eff
    if mp <= 1:
        return (DEFAULT_COLLECTIVE,)
    if collective is None:
        if can_psum_scatter(shape, eff):
            return COLLECTIVE_MODES
        return (DEFAULT_COLLECTIVE,)
    validate_collective(collective)
    return (collective,)


def _kernel_shape(shape: MBConvShape, local: MBConvShape) -> MBConvShape:
    """The shape the MBConv kernels run at on one device: the shard, with
    an identity expand's input cut to its c_mid slice (the sharded wrapper
    slices a replicated input; the pricing keeps the JAX package's full
    c_in there)."""
    if shape.has_expand:
        return local
    return replace(local, c_in=local.c_mid)


def select_mbconv_schedule(shape: MBConvShape, mode: Optional[str] = None,
                           mesh_shape: MeshShape = (1, 1),
                           collective: Optional[str] = None,
                           in_layout: str = DEFAULT_LAYOUT
                           ) -> MBConvSchedule:
    """Least modeled bytes over (tile_h, mode, collective); ``mode`` pins
    the pass-2 variant, ``collective`` the projection's reduction, and
    ``in_layout`` states how the input arrives.  Tiles are solved at the
    shard shape; the bytes are the mesh-wide total."""
    if mode is not None and mode not in MBCONV_MODES:
        raise ValueError(mode)
    validate_layout(in_layout)
    modes = MBCONV_MODES if mode is None else (mode,)
    local, eff = mbconv_shard(shape, mesh_shape, in_layout)
    kern = _kernel_shape(shape, local)
    colls = _collective_set(shape, eff, collective)
    cands = []
    for th in _tile_h_candidates(kern):
        tw = _pick_tile_w(kern, th)
        if tw is None:
            continue
        for m in modes:
            for coll in colls:
                st = sharded_mbconv_traffic(shape, th, m, eff, C_BLOCK, coll,
                                            in_layout)
                cands.append(MBConvSchedule(th, tw, m, **_mesh_terms(st)))
    if not cands:
        raise ValueError(f"no MBConv tile fits the CTA budget: {shape}")
    best = min(cands, key=lambda c: (c.total_bytes, -c.tile_h,
                                     c.mode != "retain",
                                     _COLLECTIVE_RANK[c.collective]))
    if best.mode != "retain":
        return best
    # retain's pass 2 is a GEMM with no tile: the tile is pass 1's alone
    th, tw = pass1_tile(kern.b, kern.out_h, kern.out_w, kern.c_in,
                        kern.c_mid, kern.k, kern.s, kern.dtype_bytes)
    return MBConvSchedule(
        th, tw, "retain", retain_splits=retain_split_cap(kern, local, th, tw),
        **_mesh_terms(sharded_mbconv_traffic(shape, th, "retain", eff,
                                             C_BLOCK, best.collective,
                                             in_layout)))


def retain_split_cap(kern: MBConvShape, local: MBConvShape, tile_h: int,
                     tile_w: int) -> Optional[int]:
    """The byte gate's bar on the retain GEMM's K splits.  Each split
    writes a partial of the whole output that the split-K sum reads
    back, so where the GEMM has few rows (small batches on the late 7x7
    blocks) ``retain_plan``'s count lifts the fused route's device-memory
    bytes (``core.hopper_traffic`` at the kernels' shape ``kern``) above
    the staged route's (at the shard ``local``, as the gates price it).
    None where its count keeps fused strictly below staged at this tile;
    else the largest count that does (1 where none does)."""
    from .hopper_traffic import mbconv_hopper_traffic, mbconv_staged_bytes

    staged = mbconv_staged_bytes(local, tile_h)
    m = kern.b * kern.out_h * kern.out_w
    cap = None
    while True:
        splits = retain_plan(m, kern.c_mid, kern.c_out, cap,
                             kern.dtype_bytes)[2]
        sch = MBConvSchedule(tile_h, tile_w, "retain", 0, retain_splits=cap)
        if (splits == 1
                or mbconv_hopper_traffic(kern, sch).dram_bytes < staged):
            return cap if cap is None else splits
        cap = splits - 1


def select_fusedmb_schedule(shape: MBConvShape,
                            mesh_shape: MeshShape = (1, 1),
                            collective: Optional[str] = None
                            ) -> FusedMBSchedule:
    """At the shard shape (c_mid / model; the input is always replicated),
    among tiles of at most FMB_MAX_TILE_PIXELS whose CTAs run no idle
    pixel lane (tiles that divide the map and fill whole warps; every tile
    where none does) and whose ``fusedmb_cost`` (SM clocks: CTAs on the
    busiest SM, their start, executed FMAs, resident warps) is within
    FMB_COST_BAND of the least, the one keeping the most warps resident on
    an SM, then the largest, then the one staging the fewest window pixels
    over the map.  The band holds the tiles the model cannot tell apart;
    among them the card ran the better-occupied and then the larger tiles
    faster (fewer CTA starts and weight streams per pixel), a sweep over
    V2-S's fused blocks at 384 batch 8 shows (at bf16 an idle row is an
    m16 row past the map).  The collective (a ``pin``,
    else the one of least mesh-wide bytes, ties to the ring) does not move
    the tile: both run the same kernel."""
    full = shape
    shape, eff = fusedmb_shard(full, mesh_shape)
    eb = shape.dtype_bytes
    cm = fusedmb_mid_chunk(shape.c_mid) if eb == 2 else 0
    pixels = shape.b * shape.out_h * shape.out_w
    cands = []
    for th in range(1, min(shape.out_h, FMB_MAX_TILE_PIXELS) + 1):
        for tw in range(1, min(shape.out_w, FMB_MAX_TILE_PIXELS // th) + 1):
            cost = fusedmb_cost(shape, th, tw)
            if cost is None:
                continue
            nc = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                     shape.k, shape.s, th, tw, eb)[0]
            threads = fusedmb_threads(nc, th * tw, eb, cm)
            ctas = (-(-shape.out_h // th) * -(-shape.out_w // tw)
                    * -(-shape.c_out // nc) * shape.b)
            warps = min(fusedmb_ctas_per_sm(
                nc, threads, fusedmb_smem_bytes(shape, th, tw), eb, cm),
                -(-ctas // SM_COUNT)) * threads // 32
            staged = (-(-shape.out_h // th) * -(-shape.out_w // tw)
                      * window_extent(th, shape.k, shape.s)
                      * window_extent(tw, shape.k, shape.s))
            idle = fusedmb_executed_pixels(shape, th, tw) > pixels
            cands.append((idle, cost, -warps, -th * tw, staged, th, tw))
    if not cands:
        raise ValueError(f"no Fused-MBConv tile fits the CTA budget: {shape}")
    idle, least = min(cands)[:2]
    th, tw = min((c for c in cands
                  if c[0] == idle and c[1] <= least * (1 + FMB_COST_BAND)),
                 key=lambda c: c[2:5])[5:]
    nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                 shape.k, shape.s, th, tw, eb)
    st = min((sharded_fusedmb_traffic(full, th, eff, C_BLOCK, coll)
              for coll in _collective_set(full, eff, collective)),
             key=lambda t: (t.total_bytes, _COLLECTIVE_RANK[t.collective]))
    return FusedMBSchedule(th, tw, nc, ci, **_mesh_terms(st))


def select_fused_schedule(shape: SeparableShape,
                          mesh_shape: MeshShape = (1, 1),
                          in_layout: str = DEFAULT_LAYOUT,
                          collective: str = DEFAULT_COLLECTIVE
                          ) -> FusedSchedule:
    """The tile of least ``fused_separable_cost`` (SM clocks of the busiest
    SM, the split sum included) at its launch plan's splits, among tiles of at
    most SEP_MAX_TILE_PIXELS whose height keeps the copied traffic model's
    fused bytes below its staged bytes (the paper's per-layer claim; every
    height where none does); ties to the larger tile, then to the taller
    one.  On a mesh the tile is solved at the shard shape: c_out / model
    for a replicated input, c_in / model for a model-sharded one (whose
    pointwise partial reduces per ``collective``).  ``total_bytes`` is the
    traffic model's at the tile's height, mesh-wide."""
    full = shape
    shape, eff = separable_shard(full, mesh_shape, in_layout)
    out_h, out_w = -(-shape.h // shape.s), -(-shape.w // shape.s)
    cands = []
    for th in range(1, min(out_h, SEP_MAX_TILE_PIXELS) + 1):
        above = (fused_separable_traffic(shape, th).total_bytes
                 >= staged_separable_traffic(shape, th).total_bytes)
        for tw in range(1, min(out_w, SEP_MAX_TILE_PIXELS // th) + 1):
            nc, splits = fused_separable_launch_plan(
                shape.b, shape.h, shape.w, shape.c_in, shape.c_out, shape.k,
                shape.s, th, tw, shape.dtype_bytes)
            cost = fused_separable_cost(shape, th, tw, splits, nc)
            if cost is not None:
                cands.append((above, cost, -th * tw, -th, th, tw, nc, splits))
    if not cands:
        raise ValueError(f"no fused separable tile fits the CTA budget: "
                         f"{shape}")
    th, tw, nc, splits = min(cands)[4:]
    return FusedSchedule(th, tw, nc, splits, **_mesh_terms(
        sharded_separable_traffic(full, th, eff, in_layout=in_layout,
                                  collective=collective)))


def mbconv_tile_fits(shape: MBConvShape, tile_h: int, tile_w: int,
                     mode: str) -> bool:
    """True where both passes of ``mode`` launch at this tile: pass 1
    within P1_MAX_TILE_PIXELS and the CTA's shared memory, and under
    recompute B2 within MAX_TILE_PIXELS and its own budget."""
    if (tile_h * tile_w > P1_MAX_TILE_PIXELS
            or pass1_smem_bytes(shape.k, shape.s, tile_h, tile_w, shape.c_in,
                                shape.c_mid, shape.dtype_bytes)
            > SMEM_BYTES):
        return False
    return mode == "retain" or (tile_h * tile_w <= MAX_TILE_PIXELS and
                                smem_bytes(shape, tile_h, tile_w)
                                <= SMEM_BYTES)


SWEEP_CHECK_RTOL = 1e-4             # x max|oracle|: the sweep's check bar


def mbconv_sweep_candidates(shape: MBConvShape) -> Tuple[dict, ...]:
    """The schedule points ``benchmark_mbconv_sweep`` times by default:
    the solver's pick under each pinned mode, then the other mode at each
    of those tiles where it fits (``mbconv_tile_fits``), so each tile
    gives a pair that differs only in the mode."""
    picks = [select_mbconv_schedule(shape, m) for m in MBCONV_MODES]
    points = [(p.tile_h, p.tile_w, p.mode) for p in picks]
    for p in picks:
        for m in MBCONV_MODES:
            if mbconv_tile_fits(shape, p.tile_h, p.tile_w, m):
                points.append((p.tile_h, p.tile_w, m))
    seen, out = set(), []
    for th, tw, m in points:
        if (th, tw, m) not in seen:
            seen.add((th, tw, m))
            out.append({"tile_h": th, "tile_w": tw, "mode": m})
    return tuple(out)


def benchmark_mbconv_sweep(
    x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj, *, stride: int,
    candidates: Sequence[dict], se_ratio: float = 0.25, iters: int = 20,
    exp_act: Optional[str] = "silu", dw_act: Optional[str] = "silu",
    se_act: Optional[str] = "silu", gate_act: Optional[str] = "sigmoid",
) -> Tuple[dict, ...]:
    """Measured MBConv sweep: time the two-pass kernels per schedule point
    on the card, device time of ``iters`` calls replayed from one CUDA graph
    (``core.telemetry.measure(..., graph=True)``).

    ``candidates`` is a sequence of ``{"tile_h", "tile_w", "mode"}`` dicts
    (``mbconv_sweep_candidates``).  Before its capture each candidate runs
    once against ``kernels.ref.mbconv_ref`` and must agree within
    SWEEP_CHECK_RTOL x max|oracle|, else the sweep raises: no point is
    timed unchecked.  Returns one result per candidate, its axes plus
    ``seconds`` (mean per call), ``max_abs_err`` and ``tol``.
    Counterpart of ``repro.core.autotune.benchmark_mbconv_sweep`` without
    its residency axis and schedule cache (TPU axes).  The tensors lie on
    the card; ``measure`` raises without CUDA."""
    from ..kernels.convdk_mbconv import convdk_mbconv_fused
    from ..kernels.ref import mbconv_ref
    from .telemetry import measure

    b, h, w_in, c_in = x.shape
    c_mid, c_out = w_proj.shape
    shape = MBConvShape(b=b, h=h, w=w_in, c_in=c_in, c_mid=c_mid,
                        c_out=c_out, k=w_dw.shape[0], s=stride,
                        se_ratio=se_ratio if w_se1 is not None else 0.0,
                        dtype_bytes=x.element_size())
    weights = (x, w_exp, w_dw, w_se1, b_se1, w_se2, b_se2, w_proj)
    acts = dict(exp_act=exp_act, dw_act=dw_act, se_act=se_act,
                gate_act=gate_act)
    ref = mbconv_ref(*weights, stride, "SAME", **acts)
    tol = SWEEP_CHECK_RTOL * float(ref.abs().max())
    results = []
    for cand in candidates:
        th, tw, md = int(cand["tile_h"]), int(cand["tile_w"]), cand["mode"]
        if not mbconv_tile_fits(shape, th, tw, md):
            raise ValueError(f"{md} does not launch at {th}x{tw}: {shape}")

        def fn(th=th, tw=tw, md=md):
            return convdk_mbconv_fused(*weights, stride=stride,
                                       padding="SAME", tile_h=th, tile_w=tw,
                                       mode=md, **acts)

        err = float((fn() - ref).abs().max())
        if not err <= tol:
            raise RuntimeError(
                f"{md} at {th}x{tw} disagrees with mbconv_ref: max|err| "
                f"{err:.3e} > {tol:.3e} ({shape})")
        m = measure(fn, iters=iters, graph=True)
        results.append({"tile_h": th, "tile_w": tw, "mode": md,
                        "seconds": m.mean_ms / 1e3, "max_abs_err": err,
                        "tol": tol})
    return tuple(results)


_CACHE: Dict[tuple, object] = {}


def get_fused_schedule(b: int, h: int, w: int, c_in: int, c_out: int,
                       k: int, s: int, dtype_bytes: int = 4,
                       mesh_shape: MeshShape = (1, 1),
                       in_layout: str = DEFAULT_LAYOUT,
                       collective: str = DEFAULT_COLLECTIVE
                       ) -> FusedSchedule:
    """Cached per-layer-shape separable-block schedule lookup (the fused
    kernel's tile; the staged route takes its tile_h too)."""
    shape = SeparableShape(b=b, h=h, w=w, c_in=c_in, c_out=c_out, k=k, s=s,
                           dtype_bytes=dtype_bytes)
    key = ("separable", shape, tuple(mesh_shape), in_layout, collective)
    if key not in _CACHE:
        _CACHE[key] = select_fused_schedule(shape, mesh_shape, in_layout,
                                            collective)
    return _CACHE[key]


def get_mbconv_schedule(
    b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int, k: int,
    s: int, se_ratio: float = 0.25, dtype_bytes: int = 4,
    mode: Optional[str] = None, mesh_shape: MeshShape = (1, 1),
    collective: Optional[str] = None, in_layout: str = DEFAULT_LAYOUT,
) -> MBConvSchedule:
    """Cached per-layer-shape schedule lookup (mesh, pins and the arrival
    layout are key axes)."""
    shape = MBConvShape(b=b, h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out,
                        k=k, s=s, se_ratio=se_ratio, dtype_bytes=dtype_bytes)
    key = ("mbconv", shape, mode, tuple(mesh_shape), collective, in_layout)
    if key not in _CACHE:
        _CACHE[key] = select_mbconv_schedule(shape, mode, mesh_shape,
                                             collective, in_layout)
    return _CACHE[key]


def get_fusedmb_schedule(
    b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int, k: int,
    s: int, dtype_bytes: int = 4, mesh_shape: MeshShape = (1, 1),
    collective: Optional[str] = None,
) -> FusedMBSchedule:
    """Cached per-layer-shape Fused-MBConv schedule lookup (the shape
    carries se_ratio 0: the family never has SE)."""
    shape = MBConvShape(b=b, h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out,
                        k=k, s=s, se_ratio=0.0, dtype_bytes=dtype_bytes)
    key = ("fusedmb", shape, tuple(mesh_shape), collective)
    if key not in _CACHE:
        _CACHE[key] = select_fusedmb_schedule(shape, mesh_shape, collective)
    return _CACHE[key]


# ---------------------------------------------------------------------------
# network-level layout solving (the JAX package's chain DP)
#
# A per-layer solve flips every on-mesh block to psum_scatter, but no
# consumer keeps the c_out-sharded output: the next real-expand entry
# gathers it back and scatter + gather == ring, word for word.  The DP
# solves the CHAIN: states are boundary layouts, each element is priced by
# the per-block selector under a pinned (collective, in_layout), and each
# boundary by ``perfmodel.layout_transition_words``.  It wins strictly
# where that identity does not hold: at the stem (a sharded stem output is
# written once per element, not once per device of each model group) and at
# identity-expand entries, which consume a sharded arrival free.
# ---------------------------------------------------------------------------

CHAIN_FAMILIES: Tuple[str, ...] = ("mbconv", "fusedmb")
SMEM_RESERVED = 1024                # shared memory the card keeps per CTA


@dataclass(frozen=True)
class BlockPlan:
    """One chain element's solved assignment inside a ``NetworkPlan``."""

    index: int
    shape: MBConvShape
    in_layout: str               # arrival layout the entry consumes
    out_layout: str              # layout the output leaves in
    schedule: Schedule           # the per-block solve under the pins
    boundary_words: int          # all-gather repaid AT this entry
    # the boundary entering this block (upstream pass 2 against this
    # block's pass 1): "pipelined" only where ``_annotate_overlap`` proved
    # it eligible
    entry_overlap: str = DEFAULT_OVERLAP
    pass_costs: Optional[MBConvPassCosts] = None
    family: str = "mbconv"
    act: str = "silu"

    @property
    def boundary_bytes(self) -> int:
        return self.boundary_words * self.shape.dtype_bytes


@dataclass(frozen=True)
class NetworkPlan:
    """A solved (or greedy) layout chain: the stem output, then every block
    with its schedule and the boundary all-gather its entry paid;
    ``head_boundary_words`` is the gather before a replicated head."""

    mesh_shape: MeshShape
    stem_layout: str
    stem_words: int              # the stem output written, mesh-wide
    blocks: Tuple[BlockPlan, ...]
    head_boundary_words: int
    dtype_bytes: int = 4
    policy: str = "solved"       # "solved" (DP) | "greedy" (per layer)

    @property
    def stem_bytes(self) -> int:
        return self.stem_words * self.dtype_bytes

    @property
    def block_bytes(self) -> int:
        return sum(p.schedule.total_bytes for p in self.blocks)

    @property
    def boundary_words(self) -> int:
        return (sum(p.boundary_words for p in self.blocks)
                + self.head_boundary_words)

    @property
    def transition_bytes(self) -> int:
        """Every layout-transition byte of the chain: the boundary gathers
        (the head's too) and the entry gathers inside the schedules."""
        return (self.boundary_words * self.dtype_bytes
                + sum(p.schedule.transition_bytes for p in self.blocks))

    @property
    def total_bytes(self) -> int:
        return (self.stem_bytes + self.block_bytes
                + self.boundary_words * self.dtype_bytes)

    @property
    def interconnect_words(self) -> int:
        """The words the plan moves between devices: every block's
        collectives and entry gathers and every boundary all-gather, the
        head's included (what a mesh forward's collectives carry)."""
        return (sum(p.schedule.collective_bytes + p.schedule.transition_bytes
                    for p in self.blocks) // self.dtype_bytes
                + self.boundary_words)

    @property
    def sharded_pairs(self) -> Tuple[Tuple[int, int], ...]:
        """Adjacent (producer, consumer) chain positions whose boundary
        stays model-sharded; the stem is -1."""
        pairs = []
        prev_idx, prev_lay = -1, self.stem_layout
        for p in self.blocks:
            if prev_lay == "model_sharded" and p.in_layout == "model_sharded":
                pairs.append((prev_idx, p.index))
            prev_idx, prev_lay = p.index, p.out_layout
        return tuple(pairs)

    @property
    def pipelined_boundaries(self) -> Tuple[int, ...]:
        """Block indices whose entry boundary pipelines."""
        return tuple(p.index for p in self.blocks
                     if p.entry_overlap == "pipelined")

    def _costs(self, p: BlockPlan) -> MBConvPassCosts:
        if p.pass_costs is not None:
            return p.pass_costs
        return _block_pass_costs(p.shape, p.schedule, self.mesh_shape,
                                 p.family)

    def block_pass_us(self, index: int, coeffs: PerfCoefficients
                      ) -> Tuple[float, float]:
        """(pass1_us, pass2_us) of one block under a calibration (the port
        keeps no default one: pass the card's fit)."""
        pc = self._costs(self.blocks[index])
        return (mbconv_pass_us(coeffs, pc.pass1, pc.pass1_collective_words),
                mbconv_pass_us(coeffs, pc.pass2, pc.pass2_collective_words))

    def serial_latency_us(self, coeffs: PerfCoefficients) -> float:
        """Modeled chain time with every boundary serial."""
        return sum(sum(self.block_pass_us(i, coeffs))
                   for i in range(len(self.blocks)))

    def pipelined_latency_us(self, coeffs: PerfCoefficients) -> float:
        """Modeled chain time honoring ``entry_overlap``: each pipelined
        boundary hides min(producer pass 2, consumer pass 1)."""
        total = self.serial_latency_us(coeffs)
        for i in range(1, len(self.blocks)):
            if self.blocks[i].entry_overlap != "pipelined":
                continue
            _p1_prev, p2_prev = self.block_pass_us(i - 1, coeffs)
            p1_cur, _p2_cur = self.block_pass_us(i, coeffs)
            total -= min(p2_prev, p1_cur)
        return total

    def boundary_latencies(self, coeffs: PerfCoefficients
                           ) -> Tuple[dict, ...]:
        """Per interior boundary: the two overlapped pass times, the serial
        and the overlap-honoring boundary time, and the mark."""
        out = []
        for i in range(1, len(self.blocks)):
            _p1, p2_prev = self.block_pass_us(i - 1, coeffs)
            p1_cur, _p2 = self.block_pass_us(i, coeffs)
            ov = self.blocks[i].entry_overlap
            out.append({
                "boundary": (self.blocks[i - 1].index, self.blocks[i].index),
                "pass2_us": p2_prev, "pass1_us": p1_cur,
                "serialized_us": boundary_overlap_us(p2_prev, p1_cur,
                                                     "serial"),
                "overlap_us": boundary_overlap_us(p2_prev, p1_cur, ov),
                "overlap": ov,
            })
        return tuple(out)


def _stem_words(b: int, h: int, w: int, c: int, mesh_shape: MeshShape,
                layout: str) -> int:
    """Mesh-wide words the stem output is written in: mp copies when
    replicated, each element once when model-sharded (where c divides)."""
    validate_layout(layout)
    _dp, mp = shard_factors(b, c, mesh_shape)
    full = b * h * w * c
    if layout == "model_sharded" and mp > 1:
        return full
    return full * max(1, mesh_shape[1])


def _chain_shapes(rows: Sequence, b: int, se_ratio: float, dtype_bytes: int
                  ) -> Tuple[Tuple[MBConvShape, str, str], ...]:
    """(shape, family, act) per chain row: ``BlockRow``s carry their own
    family, act and SE ratio; plain (h, w, c_in, c_mid, c_out, k, s)
    tuples are MBConv rows at the chain-wide ``se_ratio``, silu."""
    out = []
    for row in rows:
        if isinstance(row, BlockRow):
            if row.family not in CHAIN_FAMILIES:
                raise ValueError(f"family must be one of {CHAIN_FAMILIES}, "
                                 f"got {row.family!r}")
            se = 0.0 if row.family == "fusedmb" else row.se_ratio
            out.append((MBConvShape(b=b, h=row.h, w=row.w, c_in=row.c_in,
                                    c_mid=row.c_mid, c_out=row.c_out,
                                    k=row.k, s=row.s, se_ratio=se,
                                    dtype_bytes=dtype_bytes),
                        row.family, row.act))
        else:
            h, w, ci, cm, co, k, s = row
            out.append((MBConvShape(b=b, h=h, w=w, c_in=ci, c_mid=cm,
                                    c_out=co, k=k, s=s, se_ratio=se_ratio,
                                    dtype_bytes=dtype_bytes),
                        "mbconv", "silu"))
    return tuple(out)


def network_rows_from_table(
    table: Sequence[Tuple[int, int, int, int, int, int]]
) -> Tuple[Tuple[int, int, int, int, int, int, int], ...]:
    """(h, w, c_in, c_mid, c_out, k, s) chain rows from a
    ``core.workloads`` MBConv table of (c_in, c_out, expand, k, s, hw)."""
    return tuple((hw, hw, ci, ci * e, co, k, s)
                 for ci, co, e, k, s, hw in table)


def _allowed_in_layouts(shape: MBConvShape,
                        mesh_shape: MeshShape) -> Tuple[str, ...]:
    """Arrivals worth offering: replicated, and model-sharded only where
    the entry takes it free (an identity expand; a real expand's entry
    gather is byte-identical to the boundary repay)."""
    if can_shard_input(shape, mesh_shape):
        return (DEFAULT_LAYOUT, "model_sharded")
    return (DEFAULT_LAYOUT,)


def _allowed_out_layouts(shape: MBConvShape,
                         mesh_shape: MeshShape) -> Tuple[str, ...]:
    _dp, mp = shard_factors(shape.b, shape.c_mid, mesh_shape)
    if mp > 1:
        return (DEFAULT_LAYOUT, "model_sharded")
    return (DEFAULT_LAYOUT,)


def _block_pass_costs(shape: MBConvShape, sch, mesh_shape: MeshShape,
                      family: str = "mbconv") -> MBConvPassCosts:
    if family == "fusedmb":
        return sharded_fusedmb_pass_costs(shape, sch.tile_h, mesh_shape,
                                          C_BLOCK, sch.collective)
    return sharded_mbconv_pass_costs(shape, sch.tile_h, sch.mode, mesh_shape,
                                     C_BLOCK, sch.collective, sch.in_layout)


BlockSelector = Callable[[MBConvShape, str, MeshShape, Optional[str], str],
                         Schedule]


def select_block_schedule(shape: MBConvShape, family: str,
                          mesh_shape: MeshShape, collective: Optional[str],
                          in_layout: str) -> Schedule:
    """The per-block selector the DP calls: the family's cached solve under
    the pinned collective and arrival layout."""
    if family == "fusedmb":
        return get_fusedmb_schedule(
            shape.b, shape.h, shape.w, shape.c_in, shape.c_mid, shape.c_out,
            shape.k, shape.s, shape.dtype_bytes, mesh_shape, collective)
    return get_mbconv_schedule(
        shape.b, shape.h, shape.w, shape.c_in, shape.c_mid, shape.c_out,
        shape.k, shape.s, shape.se_ratio, shape.dtype_bytes,
        mesh_shape=mesh_shape, collective=collective, in_layout=in_layout)


def _pass2_smem_bytes(p: BlockPlan, mesh_shape: MeshShape) -> int:
    """Shared memory of one CTA of a two-pass block's pass 2 at its
    shard."""
    local, _ = mbconv_shard(p.shape, mesh_shape, p.in_layout)
    kern = _kernel_shape(p.shape, local)
    sch = p.schedule
    if sch.mode == "retain":
        bm, bn, _ = retain_plan(kern.b * kern.out_h * kern.out_w,
                                kern.c_mid, kern.c_out)
        return retain_smem_bytes(bm, bn, kern.dtype_bytes)
    return smem_bytes(kern, sch.tile_h, sch.tile_w)


def _pass1_smem_bytes(p: BlockPlan, mesh_shape: MeshShape) -> int:
    """Shared memory of one CTA of a block's first launch at its shard (a
    Fused-MBConv block's single pass)."""
    sch = p.schedule
    if p.family == "fusedmb":
        local, _ = fusedmb_shard(p.shape, mesh_shape)
        return fusedmb_smem_bytes(local, sch.tile_h, sch.tile_w)
    local, _ = mbconv_shard(p.shape, mesh_shape, p.in_layout)
    kern = _kernel_shape(p.shape, local)
    return pass1_smem_bytes(kern.k, kern.s, sch.tile_h, sch.tile_w,
                            kern.c_in, kern.c_mid, kern.dtype_bytes)


def _annotate_overlap(plan: NetworkPlan) -> NetworkPlan:
    """Mark every boundary a chain executor could pipeline: the consumer's
    first launch beside the producer's pass 2 (they share no buffer but the
    activation streamed between them, which ``models.blockgraph`` proves).
    Boundary i-1 -> i pipelines iff

    * the producer has a pass 2 (a single-pass Fused-MBConv does not) and
      both the producer's pass 2 and the consumer's pass 1 launch (a no-SE
      recompute block has no pass 1);
    * the consumer's entry gathers nothing (a boundary repay or an entry
      all-gather is a barrier its first load waits on);
    * one CTA of each fits one SM's shared memory together, the card's
      twin of the JAX package's halved VMEM budget, so the two can be
      resident at once.

    Overlap moves time, never bytes: the schedules stay as solved.  The
    JAX package also asks its calibration whether the overlap hides time;
    the port has no default calibration (``NetworkPlan.block_pass_us``
    takes the card's fit), and both passes launching is what that check
    reads under a fit with a positive base."""
    blocks = list(plan.blocks)
    for i in range(1, len(blocks)):
        prev, cur = blocks[i - 1], blocks[i]
        if prev.family == "fusedmb":
            continue
        if cur.boundary_words != 0 or cur.schedule.transition_bytes != 0:
            continue
        if (plan._costs(prev).pass2.total_words == 0
                or plan._costs(cur).pass1.total_words == 0):
            continue
        smem = (_pass2_smem_bytes(prev, plan.mesh_shape)
                + _pass1_smem_bytes(cur, plan.mesh_shape)
                + 2 * SMEM_RESERVED)
        if smem > SMEM_PER_SM:
            continue
        blocks[i] = replace(cur, entry_overlap="pipelined")
        telemetry.counter("autotune.network_plan.pipelined_boundary")
    return replace(plan, blocks=tuple(blocks))


def _block_plan(i: int, shape: MBConvShape, family: str, act: str, sch,
                bwords: int, mesh_shape: MeshShape) -> BlockPlan:
    return BlockPlan(index=i, shape=shape, in_layout=sch.in_layout,
                     out_layout=sch.out_layout, schedule=sch,
                     boundary_words=bwords,
                     pass_costs=_block_pass_costs(shape, sch, mesh_shape,
                                                  family),
                     family=family, act=act)


def solve_network_schedule(
    rows: Sequence, b: int, mesh_shape: MeshShape = (1, 1),
    dtype_bytes: int = 4, se_ratio: float = 0.25,
    select: BlockSelector = select_block_schedule,
) -> NetworkPlan:
    """DP over the block chain choosing each block's (collective, in
    layout, out layout) jointly for the fewest modeled bytes end to end.

    ``rows`` are ``BlockRow``s or (h, w, c_in, c_mid, c_out, k, s) MBConv
    tuples; the stem boundary is seeded from the first block's input.
    Each (state, in layout, out layout) candidate costs the boundary
    transition plus ``select(shape, family, mesh_shape, collective,
    in_layout)``, the per-block solve under those pins (a Fused-MBConv
    entry is replicated only).  Byte ties keep boundaries replicated:
    candidates come replicated first and only a strict improvement
    replaces a state.  Then ``_annotate_overlap`` marks the boundaries
    that can pipeline."""
    chain = _chain_shapes(rows, b, se_ratio, dtype_bytes)
    if not chain:
        raise ValueError("network solve needs at least one block row")
    first = chain[0][0]
    h0, w0, c0 = first.h, first.w, first.c_in
    _dp0, mp0 = shard_factors(b, c0, mesh_shape)
    stem_opts = [DEFAULT_LAYOUT] + (["model_sharded"] if mp0 > 1 else [])
    # boundary layout -> (bytes so far, stem layout, block plans)
    states: Dict[str, tuple] = {}
    for lay in stem_opts:
        cost = _stem_words(b, h0, w0, c0, mesh_shape, lay) * dtype_bytes
        cur = states.get(lay)
        if cur is None or cost < cur[0]:
            states[lay] = (cost, lay, ())
    prev_dims = (h0, w0, c0)
    for i, (shape, family, act) in enumerate(chain):
        in_lays = ((DEFAULT_LAYOUT,) if family == "fusedmb"
                   else _allowed_in_layouts(shape, mesh_shape))
        new_states: Dict[str, tuple] = {}
        for prev_lay, (cost, stem_lay, plans) in states.items():
            for in_lay in in_lays:
                bwords = layout_transition_words(
                    b, prev_dims[0], prev_dims[1], prev_dims[2],
                    mesh_shape, prev_lay, in_lay)
                for out_lay in _allowed_out_layouts(shape, mesh_shape):
                    coll = ("psum_scatter" if out_lay == "model_sharded"
                            else DEFAULT_COLLECTIVE)
                    sch = select(shape, family, mesh_shape, coll, in_lay)
                    total = cost + bwords * dtype_bytes + sch.total_bytes
                    cur = new_states.get(sch.out_layout)
                    if cur is None or total < cur[0]:
                        new_states[sch.out_layout] = (
                            total, stem_lay, plans + (_block_plan(
                                i, shape, family, act, sch, bwords,
                                mesh_shape),))
        states = new_states
        prev_dims = (shape.out_h, shape.out_w, shape.c_out)
    best = None
    for lay, (cost, stem_lay, plans) in states.items():
        head_words = layout_transition_words(
            b, prev_dims[0], prev_dims[1], prev_dims[2], mesh_shape,
            lay, DEFAULT_LAYOUT)
        total = cost + head_words * dtype_bytes
        if best is None or total < best[0]:
            best = (total, stem_lay, plans, head_words)
    total, stem_lay, plans, head_words = best
    plan = NetworkPlan(
        mesh_shape=tuple(mesh_shape), stem_layout=stem_lay,
        stem_words=_stem_words(b, h0, w0, c0, mesh_shape, stem_lay),
        blocks=plans, head_boundary_words=head_words,
        dtype_bytes=dtype_bytes, policy="solved")
    assert plan.total_bytes == total   # the parts re-sum to the DP's cost
    plan = _annotate_overlap(plan)
    assert plan.total_bytes == total   # overlap moves time, never bytes
    return plan


def greedy_network_schedule(
    rows: Sequence, b: int, mesh_shape: MeshShape = (1, 1),
    dtype_bytes: int = 4, se_ratio: float = 0.25,
    select: BlockSelector = select_block_schedule,
) -> NetworkPlan:
    """The per-layer reference the DP is gated against: every block solved
    alone (replicated arrival, free collective: psum_scatter wherever it
    runs), the stem replicated, and every sharded exit repaid by an
    all-gather at the next entry."""
    chain = _chain_shapes(rows, b, se_ratio, dtype_bytes)
    if not chain:
        raise ValueError("network solve needs at least one block row")
    first = chain[0][0]
    h0, w0, c0 = first.h, first.w, first.c_in
    plans = []
    prev_lay, prev_dims = DEFAULT_LAYOUT, (h0, w0, c0)
    for i, (shape, family, act) in enumerate(chain):
        sch = select(shape, family, mesh_shape, None, DEFAULT_LAYOUT)
        bwords = layout_transition_words(
            b, prev_dims[0], prev_dims[1], prev_dims[2], mesh_shape,
            prev_lay, DEFAULT_LAYOUT)
        plans.append(_block_plan(i, shape, family, act, sch, bwords,
                                 mesh_shape))
        prev_lay = sch.out_layout
        prev_dims = (shape.out_h, shape.out_w, shape.c_out)
    head_words = layout_transition_words(
        b, prev_dims[0], prev_dims[1], prev_dims[2], mesh_shape,
        prev_lay, DEFAULT_LAYOUT)
    return NetworkPlan(
        mesh_shape=tuple(mesh_shape), stem_layout=DEFAULT_LAYOUT,
        stem_words=_stem_words(b, h0, w0, c0, mesh_shape, DEFAULT_LAYOUT),
        blocks=tuple(plans), head_boundary_words=head_words,
        dtype_bytes=dtype_bytes, policy="greedy")


@functools.lru_cache(maxsize=64)
def _network_plan_cached(rows: tuple, b: int, mesh_shape: MeshShape,
                         dtype_bytes: int, se_ratio: float) -> NetworkPlan:
    return solve_network_schedule(rows, b, mesh_shape, dtype_bytes,
                                  se_ratio)


def get_network_plan(rows: Sequence, b: int, mesh_shape: MeshShape = (1, 1),
                     dtype_bytes: int = 4, se_ratio: float = 0.25
                     ) -> NetworkPlan:
    """Cached network solve; ``autotune.network_plan.solve`` counts a fresh
    DP, ``autotune.network_plan.reuse`` a cache hit."""
    misses = _network_plan_cached.cache_info().misses
    frozen = tuple(r if isinstance(r, BlockRow) else tuple(r) for r in rows)
    plan = _network_plan_cached(frozen, b, tuple(mesh_shape), dtype_bytes,
                                se_ratio)
    solved = _network_plan_cached.cache_info().misses > misses
    telemetry.counter("autotune.network_plan.solve" if solved
                      else "autotune.network_plan.reuse")
    return plan
