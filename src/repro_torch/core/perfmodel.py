"""HBM traffic model of the separable, fused MBConv and Fused-MBConv
pipelines.

A copy of the separable, MBConv and Fused-MBConv pricing of
``repro.core.perfmodel`` (the port imports nothing of the JAX package):
``SeparableShape``, ``MBConvShape``, ``HBMTraffic``, ``pick_channel_block``,
the staged and fused separable traffic, the per-pass / whole-block traffic
of the retain and recompute modes, and the single-pass Fused-MBConv
traffic, all under the strip-staged (DMA) input residency the JAX package
defaults to and the Hopper kernels match.  The separable and Fused-MBConv
tile_h and the retain/recompute choice of ``core.autotune`` are priced
here.

The model counts full-width row strips: it does not yet price the halo
the Hopper kernels re-read along W when they tile the output in two
dimensions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

MBCONV_MODES: Tuple[str, ...] = ("retain", "recompute")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pick_channel_block(c: int, cap: int = 128) -> int:
    """Channel block size minimizing zero-padding, then maximizing width.

    Among blocks b <= cap (multiples of 8), pick the one whose padded
    channel count ``round_up(c, b)`` is smallest, ties toward the widest.
    """
    c8 = _round_up(max(c, 1), 8)
    if c8 <= cap:
        return c8
    return min((b for b in range(8, cap + 1, 8)),
               key=lambda b: (_round_up(c8, b), -b))


@dataclass(frozen=True)
class HBMTraffic:
    """HBM words moved by one block under one pipeline; ``dma_issues``
    counts the strip-window copies the staging issues."""

    read_words: int
    write_words: int
    dtype_bytes: int = 4
    dma_issues: int = 0

    @property
    def total_words(self) -> int:
        return self.read_words + self.write_words

    @property
    def total_bytes(self) -> int:
        return self.total_words * self.dtype_bytes


@dataclass(frozen=True)
class MBConvShape:
    """One MBConv block instance as the kernels see it."""

    b: int          # batch
    h: int          # ifmap height (pre-padding)
    w: int          # ifmap width
    c_in: int       # block input channels
    c_mid: int      # expanded channels (the DW / SE width)
    c_out: int      # projection output channels
    k: int          # square DW kernel
    s: int          # stride
    se_ratio: float = 0.25
    dtype_bytes: int = 4

    @property
    def out_h(self) -> int:
        return -(-self.h // self.s)

    @property
    def out_w(self) -> int:
        return -(-self.w // self.s)

    @property
    def padded_w(self) -> int:
        return (self.out_w - 1) * self.s + self.k

    @property
    def has_se(self) -> bool:
        """``se_ratio <= 0`` means no squeeze-excite: no pool, MLP or gate."""
        return self.se_ratio > 0

    @property
    def c_se(self) -> int:
        """SE bottleneck width, sized off the block INPUT channels."""
        if not self.has_se:
            return 0
        return max(1, int(self.c_in * self.se_ratio))

    @property
    def has_expand(self) -> bool:
        return self.c_mid != self.c_in

    @property
    def se_words(self) -> int:
        """SE MLP parameter words (two FCs + biases); zero without SE."""
        if not self.has_se:
            return 0
        return 2 * self.c_mid * self.c_se + self.c_se + self.c_mid


@dataclass(frozen=True)
class SeparableShape:
    """One depthwise-separable block instance as the kernels see it."""

    b: int          # batch
    h: int          # ifmap height (pre-padding)
    w: int          # ifmap width
    c_in: int       # depthwise / expanded channels
    c_out: int      # pointwise projection channels
    k: int          # square kernel
    s: int          # stride
    dtype_bytes: int = 4

    @property
    def out_h(self) -> int:
        return -(-self.h // self.s)

    @property
    def out_w(self) -> int:
        return -(-self.w // self.s)

    @property
    def padded_w(self) -> int:
        return (self.out_w - 1) * self.s + self.k

    @property
    def padded_h(self) -> int:
        return (self.out_h - 1) * self.s + self.k


def _strip_counts(shape, tile_h: int) -> Tuple[int, int]:
    """(n_th, in_rows): row-strip count and staged rows per strip."""
    tile_h = max(1, min(tile_h, shape.out_h))
    n_th = -(-shape.out_h // tile_h)
    in_rows = (tile_h - 1) * shape.s + shape.k
    return n_th, in_rows


def _n_co_blocks(c_out: int, c_block: int) -> int:
    return -(-c_out // min(c_block, max(8, _round_up(c_out, 8))))


def _n_chan_blocks(c: int, c_block: int) -> int:
    cb = pick_channel_block(c, c_block)
    return _round_up(c, cb) // cb


def staged_separable_traffic(shape: SeparableShape,
                             tile_h: int) -> HBMTraffic:
    """HBM traffic of the staged two-kernel pipeline.

    1. stage_row_strips: read the padded input once, WRITE the overlapping
       strips tensor (halo rows duplicated in HBM),
    2. DW kernel: read the strips + DW taps, write the DW output,
    3. PW matmul: re-read the DW output + PW weight, write the block output.
    """
    n_th, in_rows = _strip_counts(shape, tile_h)
    strips = shape.b * n_th * in_rows * shape.padded_w * shape.c_in
    ifmap = shape.b * shape.padded_h * shape.padded_w * shape.c_in
    tile_h_eff = max(1, min(tile_h, shape.out_h))
    dw_out = shape.b * n_th * tile_h_eff * shape.out_w * shape.c_in
    out = shape.b * shape.out_h * shape.out_w * shape.c_out
    w_dw = shape.k * shape.k * shape.c_in
    w_pw = shape.c_in * shape.c_out
    reads = ifmap + strips + w_dw + dw_out + w_pw
    writes = strips + dw_out + out
    return HBMTraffic(reads, writes, shape.dtype_bytes)


def fused_separable_traffic(
    shape: SeparableShape, tile_h: int, c_block: int = 128,
) -> HBMTraffic:
    """HBM traffic of the fused single-pass pipeline under the strip-DMA
    residencies: each (strip, c_in block) window is read once per c_out
    block straight from the unstaged input (halo rows re-read across
    strips, never written), the DW output lives and dies on chip, the only
    activation write is the block output, and weight blocks are re-read per
    revisiting strip (DW taps per c_out block too)."""
    n_th, in_rows = _strip_counts(shape, tile_h)
    n_co = -(-shape.c_out // min(c_block, max(8, shape.c_out)))
    n_ci = _n_chan_blocks(shape.c_in, c_block)
    strips = shape.b * n_th * in_rows * shape.padded_w * shape.c_in
    out = shape.b * shape.out_h * shape.out_w * shape.c_out
    w_dw = shape.k * shape.k * shape.c_in * n_th * n_co
    w_pw = shape.c_in * shape.c_out * n_th
    issues = shape.b * n_th * n_co * n_ci
    return HBMTraffic(strips * n_co + w_dw + w_pw, out, shape.dtype_bytes,
                      issues)


def _mbconv_common(shape: MBConvShape, tile_h: int, c_block: int):
    n_th, in_rows = _strip_counts(shape, tile_h)
    tile_h_eff = max(1, min(tile_h, shape.out_h))
    cm_block = pick_channel_block(shape.c_mid, c_block)
    n_cm = _round_up(shape.c_mid, cm_block) // cm_block
    n_co = _n_co_blocks(shape.c_out, c_block)
    strips = shape.b * n_th * in_rows * shape.padded_w * shape.c_in
    # DW tensor words as retained (whole strips incl. masked rows)
    e_rows = shape.b * n_th * tile_h_eff * shape.out_w * shape.c_mid
    out = shape.b * shape.out_h * shape.out_w * shape.c_out
    w_exp = shape.c_in * shape.c_mid if shape.has_expand else 0
    w_dw = shape.k * shape.k * shape.c_mid
    w_proj = shape.c_mid * shape.c_out
    pool = shape.b * shape.c_mid
    return n_th, n_cm, n_co, strips, e_rows, out, w_exp, w_dw, w_proj, pool


def mbconv_pass_traffic(
    shape: MBConvShape, tile_h: int, mode: str = "retain",
    c_block: int = 128,
) -> Tuple[HBMTraffic, HBMTraffic]:
    """Per-pass HBM traffic ``(pass1, pass2)`` of the two-pass pipeline;
    the fields sum exactly to ``mbconv_fused_traffic``.

    * pass 1: input strip reads per c_mid block + per-strip expand/DW
      weight refetches + the SE pool and MLP words, and under ``retain``
      the one DW-tensor write.
    * pass 2: the retained-DW re-read per c_out block (or the recompute
      re-read of strips + expand/DW weights), the SE scale and projection
      weight reads, and the block's only activation write.

    A no-SE block under ``recompute`` skips pass 1 entirely (zero words).
    """
    if mode not in MBCONV_MODES:
        raise ValueError(mode)
    (n_th, n_cm, n_co, strips, e_rows, out, w_exp, w_dw, w_proj,
     pool) = _mbconv_common(shape, tile_h, c_block)
    n_ci = _n_chan_blocks(shape.c_in, c_block)
    se = shape.has_se
    scale = pool if se else 0
    issues1 = reads1 = writes1 = 0
    if se or mode == "retain":
        reads1 = strips * n_cm + (w_exp + w_dw) * n_th
        issues1 = shape.b * n_cm * n_th * n_ci
    if se:
        writes1 += pool
        reads1 += pool + shape.se_words
        writes1 += scale
    if mode == "retain":
        writes1 += e_rows
        reads2 = e_rows * n_co + scale * n_th * n_co + w_proj * n_th
        issues2 = shape.b * n_co * n_th * n_cm
    else:
        reads2 = (strips * n_cm * n_co + (w_exp + w_dw) * n_th * n_co
                  + scale * n_th * n_co + w_proj * n_th)
        issues2 = shape.b * n_co * n_th * n_cm * n_ci
    return (HBMTraffic(reads1, writes1, shape.dtype_bytes, issues1),
            HBMTraffic(reads2, out, shape.dtype_bytes, issues2))


def mbconv_fused_traffic(
    shape: MBConvShape, tile_h: int, mode: str = "retain",
    c_block: int = 128,
) -> HBMTraffic:
    """HBM traffic of the two-pass fused MBConv pipeline (one mode),
    defined as the sum of ``mbconv_pass_traffic``."""
    p1, p2 = mbconv_pass_traffic(shape, tile_h, mode, c_block)
    return HBMTraffic(p1.read_words + p2.read_words,
                      p1.write_words + p2.write_words,
                      shape.dtype_bytes, p1.dma_issues + p2.dma_issues)


# ---------------------------------------------------------------------------
# Fused-MBConv (EfficientNet-V2): one dense k x k conv (C_in -> C_mid) in
# place of expand + DW, never SE, so the whole block is ONE pass.  It is
# priced through the same (pass1, pass2) interface as MBConv, with pass 1
# carrying the entire block and pass 2 exactly zero.
# ---------------------------------------------------------------------------

def _require_no_se(shape: MBConvShape) -> None:
    if shape.has_se:
        raise ValueError(
            f"Fused-MBConv never carries SE; got se_ratio="
            f"{shape.se_ratio!r} — build the shape with se_ratio=0")


def fusedmb_pass_traffic(
    shape: MBConvShape, tile_h: int, c_block: int = 128,
) -> Tuple[HBMTraffic, HBMTraffic]:
    """Per-pass HBM traffic of the single-pass Fused-MBConv pipeline:
    ``(whole_block, exactly_zero)``.

    The one launch reads each input strip once per (c_mid, c_out) block
    pair, refetches the dense conv weight per (strip, c_out) cell and the
    projection weight per strip, and writes only the block output: the
    expanded map never reaches HBM.
    """
    _require_no_se(shape)
    (n_th, n_cm, n_co, strips, _e_rows, out, _w_exp, _w_dw, w_proj,
     _pool) = _mbconv_common(shape, tile_h, c_block)
    n_ci = _n_chan_blocks(shape.c_in, c_block)
    w_conv = shape.k * shape.k * shape.c_in * shape.c_mid
    reads = (strips * n_cm * n_co + w_conv * n_th * n_co + w_proj * n_th)
    issues = shape.b * n_co * n_th * n_cm * n_ci
    return (HBMTraffic(reads, out, shape.dtype_bytes, issues),
            HBMTraffic(0, 0, shape.dtype_bytes, 0))


def fusedmb_fused_traffic(shape: MBConvShape, tile_h: int,
                          c_block: int = 128) -> HBMTraffic:
    """HBM traffic of the single-pass Fused-MBConv pipeline, defined as
    the sum of ``fusedmb_pass_traffic`` (whose pass 2 is exactly zero)."""
    p1, p2 = fusedmb_pass_traffic(shape, tile_h, c_block)
    return HBMTraffic(p1.read_words + p2.read_words,
                      p1.write_words + p2.write_words,
                      shape.dtype_bytes, p1.dma_issues + p2.dma_issues)
