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

The separable and Fused-MBConv blocks have no mode axis (one pass), and on
one card no family has a residency or collective axis.  Schedules are
cached in-process by family, shape and mode pin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

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
    """Dynamic shared memory of the larger of the two expand+DW kernels:
    the f32 expanded window plus the per-tile DW block (pass 2) or the
    pool reduction rows (pass 1, never larger)."""
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
    return min(cands, key=lambda c: (c.total_bytes, -c.tile_h,
                                     c.mode != "retain"))


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
