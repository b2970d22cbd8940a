"""Per-layer MBConv schedules for the Hopper kernels.

Counterpart of ``repro.core.autotune``'s MBConv solver, handed a Hopper
budget instead of the TPU one.  The kernels (``kernels/csrc/mbconv.cu``)
tile the output in two dimensions, ``tile_h x tile_w`` pixels by one
channel tile, because a full-width expanded window does not fit a CTA's
shared memory.  The solver picks:

* ``mode`` (retain | recompute) and ``tile_h`` from the copied traffic
  model (``core.perfmodel.mbconv_fused_traffic``), least bytes first,
  ties to the larger tile and then to retain, as the JAX solver does;
* ``tile_w`` so the expanded window fits shared memory and the tile
  stays within the kernels' per-CTA pixel cap, staging the fewest input
  columns over the row (ties to the wider tile).

Schedules are cached in-process by shape and mode pin.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from .perfmodel import MBCONV_MODES, MBConvShape, mbconv_fused_traffic


# Budget of one H100 CTA for the MBConv kernels.  C_BLOCK and
# MAX_TILE_PIXELS are compiled into kernels/csrc/mbconv.cu (its channel tile
# and per-CTA output-pixel cap); the wrappers check them against the built
# library.
SMEM_BYTES = 232448                 # 227 KB dynamic smem per CTA
C_BLOCK = 32                        # one warp lane per channel
MAX_TILE_PIXELS = 64                # tile_h * tile_w cap
TILE_H_CANDIDATES = (1, 2, 4, 8)


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


def _pick_tile_w(shape: MBConvShape, tile_h: int) -> Optional[int]:
    cap = min(shape.out_w, MAX_TILE_PIXELS // tile_h)
    fits = [tw for tw in range(1, cap + 1)
            if smem_bytes(shape, tile_h, tw) <= SMEM_BYTES]
    if not fits:
        return None
    return min(fits, key=lambda tw: (
        -(-shape.out_w // tw) * window_extent(tw, shape.k, shape.s), -tw))


def select_mbconv_schedule(shape: MBConvShape,
                           mode: Optional[str] = None) -> MBConvSchedule:
    """Least modeled bytes over (tile_h, mode); ``mode`` pins the pass-2
    variant."""
    if mode is not None and mode not in MBCONV_MODES:
        raise ValueError(mode)
    modes = MBCONV_MODES if mode is None else (mode,)
    cands = []
    for th in sorted({max(1, min(t, shape.out_h))
                      for t in TILE_H_CANDIDATES}):
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


_CACHE: Dict[tuple, MBConvSchedule] = {}


def get_mbconv_schedule(
    b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int, k: int,
    s: int, se_ratio: float = 0.25, dtype_bytes: int = 4,
    mode: Optional[str] = None,
) -> MBConvSchedule:
    """Cached per-layer-shape schedule lookup."""
    shape = MBConvShape(b=b, h=h, w=w, c_in=c_in, c_mid=c_mid, c_out=c_out,
                        k=k, s=s, se_ratio=se_ratio, dtype_bytes=dtype_bytes)
    key = (shape, mode)
    if key not in _CACHE:
        _CACHE[key] = select_mbconv_schedule(shape, mode)
    return _CACHE[key]
