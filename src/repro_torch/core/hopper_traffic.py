"""Memory traffic of the Hopper kernels at their own tiles, at two levels.

``core.perfmodel``'s HBM model is the JAX package's twin: it prices full-
width row strips and a channel block (``core.autotune.C_BLOCK``) that the
redesigned kernels no longer use, so it stays what the solver ranks by
and what ``tests/test_torch_cim_model.py`` holds equal to JAX.  This
module prices the schedule the solver picked as the kernels of
``kernels/csrc/{mbconv,fusedmb,separable}.cu`` run it: pass 1's
``tile_h x tile_w`` window with its halo in both dimensions per c_mid tile
(``pass1_cm_tile``), the retain GEMM at ``retain_plan``'s (BM, BN,
splits), B2 at ``recompute_plan``'s (c_out tile, splits), B5 at its chunk
and C_in window chunk (``fusedmb_launch_plan``), B4 at SEP_CI_CHUNK and
its splits, and the split reduces B3' and B4'.

Two levels, per launch (``LaunchTraffic``):

* ``global_bytes``: every load and store the launch's CTAs issue, counted
  per CTA (bytes a CTA loads several times count each time; loads of one
  address by several threads of one CTA count once; zero-filled copies of
  padding and masked channels count nothing).
* ``dram_bytes``: what reaches device memory: each distinct input byte once
  plus every byte written.  Re-reads hit the 50 MiB L2 (``L2_BYTES``),
  with one exception: where the launch's distinct footprint (inputs plus
  outputs) exceeds the L2, its re-reads of activations (windows re-read
  per halo, per c_mid or c_out tile, per split) count again.  Weights,
  taps and gates are read by every CTA of a wave at once and stay
  resident.  A tensor that one launch writes and the next reads counts
  once for the write and once for the read: the staged model's rule, op
  by op.

The paper's claim is the second level: the expanded tensor never reaches
device memory.  The SE MLP between the passes (PyTorch calls on the
(B, C_mid) pool) is priced as one step reading the pool and the SE weights
and writing the gate; the residual add, which both routes run alike, is
not priced (nor is it in the staged model).  The SE pool's arrival
counters (one int per CTA) are not counted.  All tensors are fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from .autotune import (
    L2_BYTES,
    P1_CI_CHUNK,
    P1_MAX_BLOCKS,
    P1_PIXEL_BLOCK,
    P1_THREADS,
    RECOMPUTE_K_CHUNK,
    RETAIN_K_CHUNK,
    SEP_CI_CHUNK,
    SM_COUNT,
    fused_separable_launch_plan,
    fusedmb_launch_plan,
    pass1_cm_tile,
    recompute_plan,
    retain_plan,
    window_extent,
)
from .perfmodel import MBConvShape, SeparableShape

__all__ = [
    "HopperTraffic",
    "LaunchTraffic",
    "fusedmb_hopper_traffic",
    "mbconv_hopper_traffic",
    "separable_hopper_traffic",
    "window_pixels",
]

F32 = 4
REDUCE_THREADS = 256                  # B3' / B4' CTA size (float4 items)
REDUCE_MAX_CTAS = SM_COUNT * 16


@dataclass(frozen=True)
class LaunchTraffic:
    """One launch (or, for ``se_mlp``, one host step): CTAs, bytes loaded
    and stored by its CTAs, the distinct input bytes, the part of the
    loads that re-reads activations, and its cp.async ring stages."""

    name: str
    pass_: int                  # 1: pass 1 and the SE MLP; 2: the rest
    ctas: int
    global_read: int
    global_write: int
    input_bytes: int            # each distinct input byte once
    act_reread: int             # loads re-reading activation bytes
    issues: int                 # CTAs x cp.async ring stages

    @property
    def footprint(self) -> int:
        return self.input_bytes + self.global_write

    @property
    def global_bytes(self) -> int:
        return self.global_read + self.global_write

    @property
    def dram_bytes(self) -> int:
        spill = self.act_reread if self.footprint > L2_BYTES else 0
        return self.input_bytes + spill + self.global_write


@dataclass(frozen=True)
class HopperTraffic:
    """A block's launches in order, with their sums."""

    launches: Tuple[LaunchTraffic, ...]

    @property
    def global_bytes(self) -> int:
        return sum(t.global_bytes for t in self.launches)

    @property
    def dram_bytes(self) -> int:
        return sum(t.dram_bytes for t in self.launches)

    @property
    def issues(self) -> int:
        return sum(t.issues for t in self.launches)

    def pass_bytes(self) -> Tuple[int, int]:
        """(pass 1, pass 2) ``dram_bytes``; they sum to the total."""
        return (sum(t.dram_bytes for t in self.launches if t.pass_ == 1),
                sum(t.dram_bytes for t in self.launches if t.pass_ == 2))


def _pads(n: int, k: int, s: int) -> int:
    """The leading SAME pad of one dimension (the extra pad trails)."""
    out = -(-n // s)
    return max(0, (out - 1) * s + k - n) // 2


def _in_bounds(n: int, k: int, s: int, tile: int) -> int:
    """Input rows (or columns) inside the image, summed over the windows
    of every ``tile``-wide output tile of one dimension."""
    out, lead = -(-n // s), _pads(n, k, s)
    ext = window_extent(tile, k, s)
    total = 0
    for o0 in range(0, out, tile):
        i0 = o0 * s - lead
        total += max(0, min(n, i0 + ext) - max(0, i0))
    return total


def window_pixels(h: int, w: int, k: int, s: int, tile_h: int,
                  tile_w: int) -> int:
    """In-image pixels of the halo'd windows of every output tile of one
    image: what the kernels stage per image and channel (the cp.async
    copies of padding pixels read nothing)."""
    return (_in_bounds(h, k, s, min(tile_h, -(-h // s)))
            * _in_bounds(w, k, s, min(tile_w, -(-w // s))))


def _p1_passes(k: int, s: int, tile_h: int, tile_w: int, c_mid: int) -> int:
    """Passes pass 1's expand makes over C_in (mbconv.cu's NB choice): one
    where P1_MAX_BLOCKS register blocks per thread cover the window."""
    lanes = P1_THREADS // (pass1_cm_tile(c_mid) // 4)
    blocks = -(-window_extent(tile_h, k, s) * window_extent(tile_w, k, s)
               // P1_PIXEL_BLOCK)
    per = -(-blocks // lanes)
    nb = 1 if per <= 1 else 2 if per <= 2 else P1_MAX_BLOCKS
    return -(-blocks // (nb * lanes))


def _reduce(name: str, splits: int, count: int) -> LaunchTraffic:
    """B3' / B4': ``splits`` partials of ``count`` floats summed into one."""
    items = count // 4 if count % 4 == 0 else count
    return LaunchTraffic(
        name, 2, min(-(-items // REDUCE_THREADS), REDUCE_MAX_CTAS),
        splits * count * F32, count * F32, splits * count * F32, 0, 0)


def _tiles(shape, tile_h: int, tile_w: int) -> Tuple[int, int, int]:
    th, tw = min(tile_h, shape.out_h), min(tile_w, shape.out_w)
    return th, tw, -(-shape.out_h // th) * -(-shape.out_w // tw)


def _expand_loads(shape: MBConvShape, th: int, tw: int, tiles: int,
                  win: int, chunks: int) -> Tuple[int, int, int, int]:
    """(x, w_exp, w_dw) bytes that ``chunks`` c_mid-tile expands + depthwise
    load per (output tile, image), summed over one image's tiles, and the
    ring stages of one such expand; ``win`` is one image's window pixels."""
    b_c = shape.c_in * F32
    if not shape.has_expand:
        # the identity expand stages its own c_mid tile of x once
        return (win * b_c, 0, tiles * shape.k ** 2 * shape.c_mid * F32, 1)
    passes = _p1_passes(shape.k, shape.s, th, tw, shape.c_mid)
    return (chunks * passes * win * b_c,
            tiles * passes * shape.c_in * shape.c_mid * F32,
            tiles * shape.k ** 2 * shape.c_mid * F32,
            passes * -(-shape.c_in // P1_CI_CHUNK))


def mbconv_hopper_traffic(shape: MBConvShape, sch) -> HopperTraffic:
    """Pass 1 (where it runs), the SE MLP, pass 2 (retain or recompute)
    and the split reduce B3' of one MBConv block at ``sch`` (``tile_h``,
    ``tile_w``, ``mode``).  A no-SE block under recompute skips pass 1,
    as the kernel does."""
    b, hw_out = shape.b, shape.out_h * shape.out_w
    th, tw, tiles = _tiles(shape, sch.tile_h, sch.tile_w)
    win = window_pixels(shape.h, shape.w, shape.k, shape.s, th, tw)
    cmt = pass1_cm_tile(shape.c_mid)
    n_cm = -(-shape.c_mid // cmt)
    x_bytes = b * shape.h * shape.w * shape.c_in * F32
    w_exp = shape.c_in * shape.c_mid * F32 if shape.has_expand else 0
    w_dw = shape.k ** 2 * shape.c_mid * F32
    pool = b * shape.c_mid * F32
    dw = b * hw_out * shape.c_mid * F32
    out = b * hw_out * shape.c_out * F32
    retain = sch.mode == "retain"
    launches = []
    if shape.has_se or retain:
        xl, wl, tl, stages = _expand_loads(shape, th, tw, tiles, win, n_cm)
        partial = b * tiles * shape.c_mid * F32 if shape.has_se else 0
        ctas = tiles * n_cm * b
        launches.append(LaunchTraffic(
            "pass1", 1, ctas,
            b * (xl + wl + tl) + partial,       # the last CTA reads partials
            partial + (pool if shape.has_se else 0) + (dw if retain else 0),
            x_bytes + w_exp + w_dw, b * xl - x_bytes, ctas * stages))
    if shape.has_se:
        se = shape.se_words * F32
        launches.append(LaunchTraffic("se_mlp", 1, 0, pool + se, pool,
                                      pool + se, 0, 0))
    gate = pool if shape.has_se else 0
    if retain:
        m, k, n = b * hw_out, shape.c_mid, shape.c_out
        bm, bn, splits = retain_plan(m, k, n)
        n_m, n_n = -(-m // bm), -(-n // bn)
        chunks = -(-k // RETAIN_K_CHUNK)
        imgs = sum((min(m, m0 + bm) - 1) // hw_out - m0 // hw_out + 1
                   for m0 in range(0, m, bm))
        gate_loads = n_n * imgs * k * F32 if shape.has_se else 0
        ctas = n_m * n_n * splits
        launches.append(LaunchTraffic(
            "retain", 2, ctas,
            n_n * dw + n_m * k * n * F32 + gate_loads,
            splits * out, dw + k * n * F32 + gate, (n_n - 1) * dw,
            n_m * n_n * chunks))
    else:
        co, splits = recompute_plan(b, shape.out_h, shape.out_w,
                                    shape.c_mid, shape.c_out, th, tw)
        n_co = -(-shape.c_out // co)
        xl, wl, tl, stages = _expand_loads(shape, th, tw, tiles, win, n_cm)
        proj = shape.c_mid * shape.c_out * F32
        ctas = tiles * n_co * b * splits
        launches.append(LaunchTraffic(
            "recompute", 2, ctas,
            b * n_co * (xl + wl + tl + tiles * gate // b) + b * tiles * proj,
            splits * out, x_bytes + w_exp + w_dw + gate + proj,
            b * n_co * xl - x_bytes,
            tiles * n_co * b * n_cm * (stages + cmt // RECOMPUTE_K_CHUNK)))
    if launches[-1].global_write > out:
        launches.append(_reduce("splitk_reduce", launches[-1].global_write
                                // out, out // F32))
    return HopperTraffic(tuple(launches))


def fusedmb_hopper_traffic(shape: MBConvShape, sch) -> HopperTraffic:
    """B5, the single Fused-MBConv launch, at ``sch``'s tile and the chunk
    and C_in window chunk ``fusedmb_launch_plan`` gives it: the window once
    per CTA (per c_mid chunk where C_in is chunked), all of w_conv and the
    c_out tile's w_proj columns per CTA, the output once."""
    b, hw_out = shape.b, shape.out_h * shape.out_w
    th, tw, tiles = _tiles(shape, sch.tile_h, sch.tile_w)
    nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                 shape.k, shape.s, th, tw)
    n_ci, n_cm = -(-shape.c_in // ci), -(-shape.c_mid // nc)
    n_co = -(-shape.c_out // nc)
    win = window_pixels(shape.h, shape.w, shape.k, shape.s, th, tw)
    x_bytes = b * shape.h * shape.w * shape.c_in * F32
    xl = b * n_co * (n_cm if n_ci > 1 else 1) * win * shape.c_in * F32
    w_conv = shape.k ** 2 * shape.c_in * shape.c_mid * F32
    w_proj = shape.c_mid * shape.c_out * F32
    ctas = tiles * n_co * b
    steps = n_cm * (n_ci * shape.k ** 2 + 1)
    restages = n_cm * n_ci - 1 if n_ci > 1 else 0
    return HopperTraffic((LaunchTraffic(
        "fusedmb", 1, ctas,
        xl + tiles * b * (n_co * w_conv + w_proj),
        b * hw_out * shape.c_out * F32, x_bytes + w_conv + w_proj,
        xl - x_bytes, ctas * (steps + restages)),))


def separable_hopper_traffic(shape: SeparableShape, sch) -> HopperTraffic:
    """B4 at ``sch``'s tile, c_out tile and C_in splits, then B4' where it
    splits: each CTA stages its split's SEP_CI_CHUNK-channel chunks (the
    halo'd window, the taps and the pointwise rows of its c_out tile)."""
    b, hw_out = shape.b, shape.out_h * shape.out_w
    th, tw, tiles = _tiles(shape, sch.tile_h, sch.tile_w)
    nc, splits = fused_separable_launch_plan(
        b, shape.h, shape.w, shape.c_in, shape.c_out, shape.k, shape.s,
        th, tw)
    n_co = -(-shape.c_out // nc)
    win = window_pixels(shape.h, shape.w, shape.k, shape.s, th, tw)
    x_bytes = b * shape.h * shape.w * shape.c_in * F32
    xl = b * n_co * win * shape.c_in * F32
    taps = shape.k ** 2 * shape.c_in * F32
    w_pw = shape.c_in * shape.c_out * F32
    out = b * hw_out * shape.c_out * F32
    chunks = -(-shape.c_in // SEP_CI_CHUNK)
    launches = [LaunchTraffic(
        "separable", 1, tiles * n_co * splits * b,
        xl + tiles * b * (n_co * taps + w_pw), splits * out,
        x_bytes + taps + w_pw, xl - x_bytes, tiles * n_co * b * chunks)]
    if splits > 1:
        launches.append(_reduce("separable_reduce", splits, out // F32))
    return HopperTraffic(tuple(launches))
