"""Memory traffic of the Hopper kernels at their own tiles, at two levels.

``core.perfmodel``'s HBM model is the JAX package's twin: it prices full-
width row strips and a channel block (``core.autotune.C_BLOCK``) that the
redesigned kernels no longer use, so it stays what the solver ranks by
and what ``tests/test_torch_cim_model.py`` holds equal to JAX.  This
module prices the schedule the solver picked as the kernels of
``kernels/csrc/{mbconv,fusedmb,separable}.cu`` run it: pass 1's
``tile_h x tile_w`` window with its halo in both dimensions per c_mid tile
(``pass1_cm_tile``), the retain GEMM at ``retain_plan``'s (BM, BN,
splits), B2 at ``recompute_plan``'s (c_out tile, splits), B5 at its c_out
tile and C_in window chunk (``fusedmb_launch_plan``), B4 at SEP_CI_CHUNK and
its splits, each split launch with its split sum (B3', B4') folded in.

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
  by op.  A split launch's fp32 partials, which its last CTA per output
  tile reads back (``readback``), count the same way: once written and
  once read, as when a second launch summed them, so folding the sum into
  the launch moved no modeled byte.

The paper's claim is the second level: the expanded tensor never reaches
device memory.  The SE MLP between the passes (PyTorch calls on the
(B, C_mid) pool) is priced as one step reading the pool and the SE weights
and writing the gate; the residual add, which both routes run alike, is
not priced (nor is it in the staged model).  The arrival counters of the
SE pool and of the split sums (one int per output tile) are not counted.  The input, the weights,
the retained DW tensor and the output are in the storage type
(``shape.dtype_bytes``: fp32 or bf16); the SE pool, its partials, the
gate and the split partials are fp32 at every storage type, as the
kernels keep them.  The separable kernel's bf16 build (B4) writes no split
partials: its C_in splits sum in a cluster's distributed shared memory.

``mbconv_staged_bytes`` and ``fusedmb_staged_bytes`` are the gates' other
side: the copied model's staged traffic with the intermediates at fp32,
as the staged routes compute them, and the storage-type operands at the
storage type (at fp32, the copied model's bytes exactly).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

from .autotune import (
    FMB_BF16_K16_PER_SLOT,
    L2_BYTES,
    P1_CI_CHUNK,
    P1_MAX_BLOCKS,
    P1_PIXEL_BLOCK,
    P1_THREADS,
    RECOMPUTE_K_CHUNK,
    RETAIN_K_CHUNK,
    SEP_CI_CHUNK,
    C_BLOCK,
    fused_separable_launch_plan,
    fusedmb_k16_steps,
    fusedmb_launch_plan,
    fusedmb_mid_chunk,
    pass1_cm_tile,
    recompute_plan,
    retain_plan,
    window_extent,
)
from .perfmodel import (
    MBConvShape,
    SeparableShape,
    fusedmb_staged_traffic,
    mbconv_staged_traffic,
)

__all__ = [
    "HopperTraffic",
    "LaunchTraffic",
    "fusedmb_hopper_traffic",
    "fusedmb_staged_bytes",
    "mbconv_hopper_traffic",
    "mbconv_staged_bytes",
    "separable_hopper_traffic",
    "window_pixels",
]

F32 = 4                               # pool, partials, gate: fp32 always


@dataclass(frozen=True)
class LaunchTraffic:
    """One launch (or, for ``se_mlp``, one host step): CTAs, bytes loaded
    and stored by its CTAs, the distinct input bytes, the part of the
    loads that re-reads activations, its cp.async ring stages, and the
    split partials its last CTAs read back (part of ``global_read``)."""

    name: str
    pass_: int                  # 1: pass 1, the SE MLP and B4; 2: the rest
    ctas: int
    global_read: int
    global_write: int
    input_bytes: int            # each distinct input byte once
    act_reread: int             # loads re-reading activation bytes
    issues: int                 # CTAs x cp.async ring stages
    readback: int = 0           # split partials written, then read once

    @property
    def footprint(self) -> int:
        """Distinct bytes live while the launch re-reads activations: its
        inputs and its stores, which for a split launch are its partials
        (a tile's output is stored by its last CTA, after the tile's
        reads)."""
        return self.input_bytes + (self.readback or self.global_write)

    @property
    def global_bytes(self) -> int:
        return self.global_read + self.global_write

    @property
    def dram_bytes(self) -> int:
        spill = self.act_reread if self.footprint > L2_BYTES else 0
        return self.input_bytes + spill + self.global_write + self.readback


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


def _tiles(shape, tile_h: int, tile_w: int) -> Tuple[int, int, int]:
    th, tw = min(tile_h, shape.out_h), min(tile_w, shape.out_w)
    return th, tw, -(-shape.out_h // th) * -(-shape.out_w // tw)


def _expand_loads(shape: MBConvShape, th: int, tw: int, tiles: int,
                  win: int, chunks: int) -> Tuple[int, int, int, int]:
    """(x, w_exp, w_dw) bytes that ``chunks`` c_mid-tile expands + depthwise
    load per (output tile, image), summed over one image's tiles, and the
    ring stages of one such expand; ``win`` is one image's window pixels."""
    eb = shape.dtype_bytes
    b_c = shape.c_in * eb
    if not shape.has_expand:
        # the identity expand stages its own c_mid tile of x once
        return (win * b_c, 0, tiles * shape.k ** 2 * shape.c_mid * eb, 1)
    passes = _p1_passes(shape.k, shape.s, th, tw, shape.c_mid)
    return (chunks * passes * win * b_c,
            tiles * passes * shape.c_in * shape.c_mid * eb,
            tiles * shape.k ** 2 * shape.c_mid * eb,
            passes * -(-shape.c_in // P1_CI_CHUNK))


def mbconv_hopper_traffic(shape: MBConvShape, sch) -> HopperTraffic:
    """Pass 1 (where it runs), the SE MLP and pass 2 (retain or recompute,
    its split sum B3' folded in) of one MBConv block at ``sch``
    (``tile_h``, ``tile_w``, ``mode``).  A no-SE block under recompute
    skips pass 1, as the kernel does."""
    b, hw_out, eb = shape.b, shape.out_h * shape.out_w, shape.dtype_bytes
    th, tw, tiles = _tiles(shape, sch.tile_h, sch.tile_w)
    win = window_pixels(shape.h, shape.w, shape.k, shape.s, th, tw)
    cmt = pass1_cm_tile(shape.c_mid)
    n_cm = -(-shape.c_mid // cmt)
    x_bytes = b * shape.h * shape.w * shape.c_in * eb
    w_exp = shape.c_in * shape.c_mid * eb if shape.has_expand else 0
    w_dw = shape.k ** 2 * shape.c_mid * eb
    pool = b * shape.c_mid * F32
    dw = b * hw_out * shape.c_mid * eb
    out_n = b * hw_out * shape.c_out
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
        bm, bn, splits = retain_plan(m, k, n, sch.retain_splits,
                                     shape.dtype_bytes)
        n_m, n_n = -(-m // bm), -(-n // bn)
        chunks = -(-k // RETAIN_K_CHUNK)
        imgs = sum((min(m, m0 + bm) - 1) // hw_out - m0 // hw_out + 1
                   for m0 in range(0, m, bm))
        gate_loads = n_n * imgs * k * F32 if shape.has_se else 0
        ctas = n_m * n_n * splits
        launches.append(_split_sum(LaunchTraffic(
            "retain", 2, ctas,
            n_n * dw + n_m * k * n * eb + gate_loads, out_n * eb,
            dw + k * n * eb + gate, (n_n - 1) * dw, n_m * n_n * chunks),
            splits, out_n))
    else:
        co, splits = recompute_plan(b, shape.out_h, shape.out_w,
                                    shape.c_mid, shape.c_out, th, tw)
        n_co = -(-shape.c_out // co)
        xl, wl, tl, stages = _expand_loads(shape, th, tw, tiles, win, n_cm)
        proj = shape.c_mid * shape.c_out * eb
        ctas = tiles * n_co * b * splits
        launches.append(_split_sum(LaunchTraffic(
            "recompute", 2, ctas,
            b * n_co * (xl + wl + tl + tiles * gate // b) + b * tiles * proj,
            out_n * eb, x_bytes + w_exp + w_dw + gate + proj,
            b * n_co * xl - x_bytes,
            tiles * n_co * b * n_cm * (stages + cmt // RECOMPUTE_K_CHUNK)),
            splits, out_n))
    return HopperTraffic(tuple(launches))


def _split_sum(t: LaunchTraffic, splits: int, count: int) -> LaunchTraffic:
    """A launch that writes ``count`` output values, with its split sum
    where it splits: the splits' fp32 partials stored, then read back once
    by the last CTA of each output tile (B3', B4' folded in)."""
    if splits == 1:
        return t
    part = splits * count * F32
    return replace(t, global_read=t.global_read + part,
                   global_write=t.global_write + part, readback=part)


def fusedmb_hopper_traffic(shape: MBConvShape, sch) -> HopperTraffic:
    """B5, the single Fused-MBConv launch, at ``sch``'s tile and the c_out
    tile and C_in window chunk ``fusedmb_launch_plan`` gives it: the window
    once per CTA (per c_mid chunk where C_in is chunked), all of w_conv and
    the c_out tile's w_proj columns per CTA, the output once.  The c_mid
    chunk is the c_out tile in fp32 and ``fusedmb_mid_chunk`` in bf16, whose
    ring stages FMB_BF16_K16_PER_SLOT k16 steps of w_conv a slot."""
    b, hw_out, eb = shape.b, shape.out_h * shape.out_w, shape.dtype_bytes
    th, tw, tiles = _tiles(shape, sch.tile_h, sch.tile_w)
    nc, ci = fusedmb_launch_plan(shape.c_in, shape.c_mid, shape.c_out,
                                 shape.k, shape.s, th, tw, eb)
    cm = fusedmb_mid_chunk(shape.c_mid) if eb == 2 else nc
    n_ci, n_cm = -(-shape.c_in // ci), -(-shape.c_mid // cm)
    n_co = -(-shape.c_out // nc)
    win = window_pixels(shape.h, shape.w, shape.k, shape.s, th, tw)
    x_bytes = b * shape.h * shape.w * shape.c_in * eb
    xl = b * n_co * (n_cm if n_ci > 1 else 1) * win * shape.c_in * eb
    w_conv = shape.k ** 2 * shape.c_in * shape.c_mid * eb
    w_proj = shape.c_mid * shape.c_out * eb
    ctas = tiles * n_co * b
    conv_steps = (sum(-(-k16 // FMB_BF16_K16_PER_SLOT) for k16 in
                      fusedmb_k16_steps(shape.c_in, shape.k, ci))
                  if eb == 2 else n_ci * shape.k ** 2)
    steps = n_cm * (conv_steps + 1)
    restages = n_cm * n_ci - 1 if n_ci > 1 else 0
    return HopperTraffic((LaunchTraffic(
        "fusedmb", 1, ctas,
        xl + tiles * b * (n_co * w_conv + w_proj),
        b * hw_out * shape.c_out * eb, x_bytes + w_conv + w_proj,
        xl - x_bytes, ctas * (steps + restages)),))


def separable_hopper_traffic(shape: SeparableShape, sch) -> HopperTraffic:
    """B4 at ``sch``'s tile, c_out tile and C_in splits, its split sum B4'
    folded in: each CTA stages its split's SEP_CI_CHUNK-channel chunks (the
    halo'd window, the taps and the pointwise rows of its c_out tile).  x,
    the taps, w_pw and the output at the storage type; in fp32 the split
    partials at fp32, written and read back; in bf16 the splits are one
    cluster's CTAs, which sum in distributed shared memory, so a split
    launch moves the unsplit launch's device-memory bytes."""
    b, hw_out, eb = shape.b, shape.out_h * shape.out_w, shape.dtype_bytes
    th, tw, tiles = _tiles(shape, sch.tile_h, sch.tile_w)
    nc, splits = fused_separable_launch_plan(
        b, shape.h, shape.w, shape.c_in, shape.c_out, shape.k, shape.s,
        th, tw, eb)
    n_co = -(-shape.c_out // nc)
    win = window_pixels(shape.h, shape.w, shape.k, shape.s, th, tw)
    x_bytes = b * shape.h * shape.w * shape.c_in * eb
    xl = b * n_co * win * shape.c_in * eb
    taps = shape.k ** 2 * shape.c_in * eb
    w_pw = shape.c_in * shape.c_out * eb
    count = b * hw_out * shape.c_out
    chunks = -(-shape.c_in // SEP_CI_CHUNK)
    launch = LaunchTraffic(
        "separable", 1, tiles * n_co * splits * b,
        xl + tiles * b * (n_co * taps + w_pw), count * eb,
        x_bytes + taps + w_pw, xl - x_bytes, tiles * n_co * b * chunks)
    return HopperTraffic((launch if eb == 2 else
                          _split_sum(launch, splits, count),))


def _mixed_staged_bytes(traffic, storage_words: int, eb: int) -> int:
    """A staged route's bytes: every word of the copied model at fp32 but
    the ``storage_words`` (input, weights, output) at ``eb`` bytes."""
    return traffic.total_words * F32 - storage_words * (F32 - eb)


def mbconv_staged_bytes(shape: MBConvShape, tile_h: int) -> int:
    """The staged MBConv route's device-memory bytes at ``tile_h``
    (``perfmodel.mbconv_staged_traffic`` at ``C_BLOCK``): the expanded and
    DW maps, their strips, the pool and the gate at fp32, as
    ``convdk_mbconv_staged`` computes them; x (where it expands), the
    expand, depthwise and projection weights and the output at the
    storage type.  The SE weights stay fp32 at every storage type."""
    eb = shape.dtype_bytes
    traffic = mbconv_staged_traffic(replace(shape, dtype_bytes=F32), tile_h,
                                    C_BLOCK)
    storage = ((shape.b * shape.h * shape.w * shape.c_in
                + shape.c_in * shape.c_mid if shape.has_expand else 0)
               + shape.k ** 2 * shape.c_mid + shape.c_mid * shape.c_out
               + shape.b * shape.out_h * shape.out_w * shape.c_out)
    return _mixed_staged_bytes(traffic, storage, eb)


def fusedmb_staged_bytes(shape: MBConvShape, tile_h: int) -> int:
    """The staged Fused-MBConv route's device-memory bytes
    (``perfmodel.fusedmb_staged_traffic``): the expanded map at fp32, the
    input, both weights and the output at the storage type."""
    eb = shape.dtype_bytes
    traffic = fusedmb_staged_traffic(replace(shape, dtype_bytes=F32), tile_h,
                                     C_BLOCK)
    storage = (shape.b * shape.h * shape.w * shape.c_in
               + shape.k ** 2 * shape.c_in * shape.c_mid
               + shape.c_mid * shape.c_out
               + shape.b * shape.out_h * shape.out_w * shape.c_out)
    return _mixed_staged_bytes(traffic, storage, eb)
