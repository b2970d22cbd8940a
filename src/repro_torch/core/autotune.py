"""Per-layer separable, MBConv and Fused-MBConv schedules for the Hopper
kernels.

Counterpart of ``repro.core.autotune``'s separable, MBConv and
Fused-MBConv solvers, handed a Hopper budget instead of the TPU one.  The
kernels (``kernels/csrc/separable.cu``, ``mbconv.cu``, ``fusedmb.cu``) tile
the output in two dimensions, ``tile_h x tile_w`` pixels, because a
full-width window does not fit a CTA's shared memory.  The solvers pick:

* ``tile_h`` (and for MBConv the ``mode``, retain | recompute) from the
  copied traffic model (``core.perfmodel``), least bytes first, ties to
  the larger tile and then to retain, as the JAX solvers do;
* ``tile_w`` so the kernel's staged window fits shared memory and the
  tile stays within the kernels' per-CTA pixel cap, staging the fewest
  input columns over the row (ties to the wider tile).

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
from typing import Callable, Dict, Optional, Tuple

from .perfmodel import (
    MBCONV_MODES,
    MBConvShape,
    SeparableShape,
    fused_separable_traffic,
    fusedmb_fused_traffic,
    mbconv_fused_traffic,
)


# Budget of one H100 CTA for the kernels.  C_BLOCK, MAX_TILE_PIXELS and
# PIXEL_STRIDE are compiled into kernels/csrc/*.cu (the channel tile, the
# per-CTA output-pixel cap, the padded floats per staged pixel); the
# wrappers check them against the built libraries.
SMEM_BYTES = 232448                 # 227 KB dynamic smem per CTA
C_BLOCK = 32                        # one warp lane per channel
MAX_TILE_PIXELS = 64                # tile_h * tile_w cap
PIXEL_STRIDE = C_BLOCK + 4          # padded against bank conflicts
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


@dataclass(frozen=True)
class FusedSchedule:
    """One separable block's schedule: output tile, the c_out tile of one
    CTA, modeled bytes."""

    tile_h: int
    tile_w: int
    co_tile: int
    total_bytes: int


@dataclass(frozen=True)
class FusedMBSchedule:
    """One Fused-MBConv block's schedule: output tile, modeled bytes."""

    tile_h: int
    tile_w: int
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
    pass 1 shares on recompute blocks: the f32 expanded window of one
    32-channel tile plus the per-tile DW block."""
    window = (window_extent(tile_h, shape.k, shape.s)
              * window_extent(tile_w, shape.k, shape.s))
    return (window + MAX_TILE_PIXELS) * C_BLOCK * 4


def co_tile(c_out: int) -> int:
    """Output channels one fused-separable or Fused-MBConv CTA projects
    (separable.cu's and fusedmb.cu's template choice): the smallest of 32,
    64, 128 covering ``c_out``."""
    return next((t for t in (32, 64) if c_out <= t), 128)


def fusedmb_window_smem_bytes(k: int, in_rows: int, in_cols: int,
                              c_out: int) -> int:
    """Dynamic shared memory of one Fused-MBConv launch staging an
    ``in_rows x in_cols`` window (fusedmb.cu's ``fusedmb_smem_bytes``, which
    the wrapper checks against this): the padded window of one c_in chunk
    and the padded (pixels, 32) activated conv tile, one (k, k, 32, 32)
    dense-conv weight chunk and one (32, co_tile) projection chunk."""
    floats = ((in_rows * in_cols + MAX_TILE_PIXELS) * PIXEL_STRIDE
              + k * k * C_BLOCK * C_BLOCK + C_BLOCK * co_tile(c_out))
    return floats * 4


def fusedmb_smem_bytes(shape: MBConvShape, tile_h: int, tile_w: int) -> int:
    """Dynamic shared memory of the Fused-MBConv kernel at one tile."""
    return fusedmb_window_smem_bytes(
        shape.k, window_extent(tile_h, shape.k, shape.s),
        window_extent(tile_w, shape.k, shape.s), shape.c_out)


def fused_separable_window_smem_bytes(k: int, in_rows: int, in_cols: int,
                                     c_out: int) -> int:
    """Dynamic shared memory of one fused-separable launch staging an
    ``in_rows x in_cols`` window (separable.cu's
    ``fused_separable_smem_bytes``, which the wrapper checks against this):
    the padded window of one c_in chunk and the padded (pixels, 32) DW
    tile, one chunk's (k, k, 32) taps and one (32, co_tile) pointwise
    chunk."""
    floats = ((in_rows * in_cols + MAX_TILE_PIXELS) * PIXEL_STRIDE
              + k * k * C_BLOCK + C_BLOCK * co_tile(c_out))
    return floats * 4


def fused_separable_smem_bytes(shape: SeparableShape, tile_h: int,
                               tile_w: int) -> int:
    """Dynamic shared memory of the fused-separable kernel at one tile."""
    return fused_separable_window_smem_bytes(
        shape.k, window_extent(tile_h, shape.k, shape.s),
        window_extent(tile_w, shape.k, shape.s), shape.c_out)


def pass1_cm_tile(c_mid: int) -> int:
    """c_mid channels one pass-1 CTA owns (mbconv.cu's ``p1_cm_tile``): 64,
    or 32 where 64-wide tiles would pad C_mid by more than an eighth."""
    pad64 = -(-c_mid // 64) * 64 - c_mid
    return 64 if c_mid >= 64 and pad64 * 8 <= c_mid else 32


def pass1_smem_bytes(k: int, s: int, tile_h: int, tile_w: int, c_in: int,
                     c_mid: int) -> int:
    """Dynamic shared memory of one pass-1 CTA with an expand (mbconv.cu's
    ``p1_smem_floats``; an identity expand takes no more): the expanded
    window (pixels rounded up to P1_PIXEL_BLOCK, padded), then one region
    holding the staged x and w_exp chunks (P1_SLOTS ring slots, fewer where
    C_in has fewer chunks) during the expand and the DW tile and pool rows
    after it."""
    cmt = pass1_cm_tile(c_mid)
    q4 = (-(-(window_extent(tile_h, k, s) * window_extent(tile_w, k, s))
            // P1_PIXEL_BLOCK) * P1_PIXEL_BLOCK)
    slots = min(P1_SLOTS, -(-c_in // P1_CI_CHUNK))
    stage = slots * (q4 * (P1_CI_CHUNK + P1_PAD) + P1_CI_CHUNK * cmt)
    after = tile_h * tile_w * (cmt + P1_PAD) + P1_THREADS // (cmt // 4) * cmt
    return (q4 * (cmt + P1_PAD) + max(stage, after)) * 4


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


def _pick_tile_w(shape, tile_h: int,
                 smem: Callable[..., int] = smem_bytes) -> Optional[int]:
    cap = min(shape.out_w, MAX_TILE_PIXELS // tile_h)
    fits = [tw for tw in range(1, cap + 1)
            if smem(shape, tile_h, tw) <= SMEM_BYTES]
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
    """Least modeled bytes over tile_h, ties to the larger tile."""
    cands = []
    for th in _tile_h_candidates(shape):
        tw = _pick_tile_w(shape, th, fusedmb_smem_bytes)
        if tw is not None:
            cands.append(FusedMBSchedule(
                th, tw, fusedmb_fused_traffic(shape, th, C_BLOCK).total_bytes))
    if not cands:
        raise ValueError(f"no Fused-MBConv tile fits the CTA budget: {shape}")
    return min(cands, key=lambda c: (c.total_bytes, -c.tile_h))


def select_fused_schedule(shape: SeparableShape) -> FusedSchedule:
    """Least modeled bytes over tile_h, ties to the larger tile.  The
    traffic is priced with 128-wide c_out blocks, which is the kernel's
    c_out tiling wherever C_out > 64 and one block below."""
    cands = []
    for th in _tile_h_candidates(shape):
        tw = _pick_tile_w(shape, th, fused_separable_smem_bytes)
        if tw is not None:
            cands.append(FusedSchedule(
                th, tw, co_tile(shape.c_out),
                fused_separable_traffic(shape, th).total_bytes))
    if not cands:
        raise ValueError(f"no fused separable tile fits the CTA budget: "
                         f"{shape}")
    return min(cands, key=lambda c: (c.total_bytes, -c.tile_h))


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
