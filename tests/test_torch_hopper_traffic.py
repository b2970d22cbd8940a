"""The Hopper byte model (``repro_torch.core.hopper_traffic``): worked
examples, the two levels' bounds, the pass split, and the solver's picks.

The model prices the schedules the port's solver picks, which the JAX
package does not have (its kernels tile 128-lane channel blocks on a TPU),
so its parity is with the kernels' own loads, worked by hand below, and
the solver's picks are pinned to the ones taken before the model existed:
the model reads the schedules and changes none of them.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.core.autotune import (
    FusedMBSchedule,
    FusedSchedule,
    MBConvSchedule,
    get_fused_schedule,
    mbconv_sweep_candidates,
)
from repro_torch.core.hopper_traffic import (
    LaunchTraffic,
    fusedmb_hopper_traffic,
    mbconv_hopper_traffic,
    separable_hopper_traffic,
    window_pixels,
)
from repro_torch.core.perfmodel import MBConvShape, SeparableShape
from repro_torch.core.workloads import (
    EFFICIENTNET_V2_K7_SEPARABLE,
    MOBILENET_V2_SEPARABLE,
)


def test_mbconv_retain_worked_by_hand():
    """1 x 4x4x4 -> 8 -> 4, k3 s1, SE (c_se 1), tile 4x4, retain.

    One output tile; its 6x6 window holds the 16 image pixels (the SAME
    pad reads nothing).  pass1_cm_tile(8) = 32, so one c_mid tile and one
    CTA; 36 window pixels are 9 register blocks over 32 pixel lanes: one
    pass over C_in, in one 16-channel ring stage.

    pass 1 loads x 16 px x 4 ch x 4 B = 256, w_exp 4 x 8 x 4 = 128, the
    taps 9 x 8 x 4 = 288 and (the last CTA) the 8-float partial, 32: 704;
    it stores the partial 32, the pool 32 and the DW tensor 16 x 8 x 4 =
    512: 576.  Inputs 672.
    SE MLP: the pool 32 and 2 x 8 x 1 + 1 + 8 = 25 SE words, 100 B; the
    gate 32.
    retain: M 16, K 8, N 4 -> (BM 64, BN 32, 1 split), one CTA, one K
    chunk: A 512, w_proj 128, the gate row 32; out 16 x 4 x 4 = 256.

    global = 704 + 576 + 132 + 32 + 672 + 256 = 2372; device memory drops
    the partial's read-back: 2340; issues 1 + 1 = 2."""
    shape = MBConvShape(b=1, h=4, w=4, c_in=4, c_mid=8, c_out=4, k=3, s=1)
    t = mbconv_hopper_traffic(shape, MBConvSchedule(4, 4, "retain", 0))
    assert t.launches == (
        LaunchTraffic("pass1", 1, 1, 704, 576, 672, 0, 1),
        LaunchTraffic("se_mlp", 1, 0, 132, 32, 132, 0, 0),
        LaunchTraffic("retain", 2, 1, 672, 256, 672, 0, 1))
    assert (t.global_bytes, t.dram_bytes, t.issues) == (2372, 2340, 2)
    assert t.pass_bytes() == (1248 + 164, 928)


def test_mbconv_recompute_without_se_skips_pass_1():
    """The same block without SE under recompute: no pass 1, no SE MLP.
    B2: c_out tile 16 (the narrowest covering 4), one CTA, 1 split; per
    chunk (one) x 256 + w_exp 128 + taps 288 + w_proj 8 x 4 x 4 = 128:
    800 loaded, all distinct; out 256.  Issues: one expand stage and
    32 / 16 = 2 w_proj stages."""
    shape = MBConvShape(b=1, h=4, w=4, c_in=4, c_mid=8, c_out=4, k=3, s=1,
                        se_ratio=0.0)
    t = mbconv_hopper_traffic(shape, MBConvSchedule(4, 4, "recompute", 0))
    assert t.launches == (
        LaunchTraffic("recompute", 2, 1, 800, 256, 800, 0, 3),)
    assert t.dram_bytes == t.global_bytes == 1056


def test_fusedmb_worked_by_hand():
    """1 x 4x4x4 -> 8 -> 4, k3 s1, tile 4x4: chunk 24 (fewest FMAs), all of
    C_in in the window.  x 256, w_conv 9 x 4 x 8 x 4 = 1152, w_proj 128;
    out 256; 9 conv steps and 1 projection step."""
    shape = MBConvShape(b=1, h=4, w=4, c_in=4, c_mid=8, c_out=4, k=3, s=1,
                        se_ratio=0.0)
    t = fusedmb_hopper_traffic(shape, FusedMBSchedule(4, 4, 0, 0, 0))
    assert t.launches == (
        LaunchTraffic("fusedmb", 1, 1, 1536, 256, 1536, 0, 10),)


def test_separable_worked_by_hand():
    """1 x 8x8x8 -> 4, k3 s1, tile 4x4: four tiles, each window 5 x 5 in
    the image (100 pixels for 64 distinct), c_out tile 16, no split.
    x 100 x 8 x 4 = 3200 (re-reads 3200 - 2048 = 1152), taps 4 tiles x
    288, w_pw 4 x 128; out 64 x 4 x 4 = 1024; one 32-channel chunk per CTA.
    The footprint is far below the L2: device memory counts x once."""
    shape = SeparableShape(b=1, h=8, w=8, c_in=8, c_out=4, k=3, s=1)
    t = separable_hopper_traffic(shape, FusedSchedule(4, 4, 0, 0, 0))
    assert t.launches == (LaunchTraffic(
        "separable", 1, 4, 3200 + 4 * 288 + 4 * 128, 1024,
        2048 + 288 + 128, 1152, 4),)
    assert t.dram_bytes == 2048 + 288 + 128 + 1024


def test_rereads_count_again_only_past_the_l2():
    """A launch whose distinct footprint exceeds the L2 pays its activation
    re-reads in device memory; a smaller one does not."""
    small = LaunchTraffic("x", 1, 1, 300, 100, 200, 100, 0)
    assert small.dram_bytes == 300
    big = LaunchTraffic("x", 1, 1, 60 * 2 ** 20, 1, 50 * 2 ** 20, 10, 0)
    assert big.dram_bytes == 50 * 2 ** 20 + 10 + 1


@pytest.mark.parametrize("seed", range(4))
def test_window_pixels_match_enumeration(seed):
    """Against a brute-force walk of every tile's window, pixel by pixel."""
    rng = np.random.default_rng(seed)
    for _ in range(25):
        h, w = (int(v) for v in rng.integers(1, 30, 2))
        k, s = int(rng.choice([1, 3, 5, 7])), int(rng.integers(1, 3))
        out_h, out_w = -(-h // s), -(-w // s)
        th, tw = (int(rng.integers(1, out_h + 1)),
                  int(rng.integers(1, out_w + 1)))
        top = max(0, (out_h - 1) * s + k - h) // 2
        left = max(0, (out_w - 1) * s + k - w) // 2
        want = 0
        for oh0, ow0 in itertools.product(range(0, out_h, th),
                                          range(0, out_w, tw)):
            for r, c in itertools.product(range((th - 1) * s + k),
                                          range((tw - 1) * s + k)):
                ih, iw = oh0 * s - top + r, ow0 * s - left + c
                want += 0 <= ih < h and 0 <= iw < w
        assert window_pixels(h, w, k, s, th, tw) == want


def _family_points():
    for fam in kb.FAMILY_CHOICES:
        _, rows, schedules = kb.family_chain(fam, kb.BATCH,
                                             kb.FAMILY_RES[fam])
        for i, (r, sch) in enumerate(zip(rows, schedules)):
            shape = kb._shape(r, kb.BATCH)
            points = [sch]
            if r.family == "mbconv":
                points += [MBConvSchedule(c["tile_h"], c["tile_w"],
                                          c["mode"], 0)
                           for c in mbconv_sweep_candidates(shape)]
            yield f"{fam}{i}", r, shape, points


def _compulsory_mbconv(shape):
    """Inputs, weights and output once (4 bytes each)."""
    words = (shape.b * shape.h * shape.w * shape.c_in
             + (shape.c_in * shape.c_mid if shape.has_expand else 0)
             + shape.k ** 2 * shape.c_mid + shape.se_words
             + shape.c_mid * shape.c_out
             + shape.b * shape.out_h * shape.out_w * shape.c_out)
    return 4 * words


def _compulsory_fusedmb(shape):
    return 4 * (shape.b * shape.h * shape.w * shape.c_in
                + shape.k ** 2 * shape.c_in * shape.c_mid
                + shape.c_mid * shape.c_out
                + shape.b * shape.out_h * shape.out_w * shape.c_out)


def _check_levels(t, compulsory):
    assert compulsory <= t.dram_bytes <= t.global_bytes
    for launch in t.launches:
        assert launch.input_bytes <= launch.global_read
        assert 0 <= launch.act_reread <= (launch.global_read
                                          - launch.input_bytes)
        assert launch.dram_bytes <= launch.global_bytes
    assert sum(t.pass_bytes()) == t.dram_bytes


def test_levels_and_passes_at_every_family_point():
    """Every block of the three families at the solver's pick and at every
    sweep point: compulsory <= device memory <= global, per launch too,
    and the passes sum to the total."""
    n = 0
    for name, r, shape, points in _family_points():
        for sch in points:
            if r.family == "fusedmb":
                _check_levels(fusedmb_hopper_traffic(shape, sch),
                              _compulsory_fusedmb(shape))
            else:
                _check_levels(mbconv_hopper_traffic(shape, sch),
                              _compulsory_mbconv(shape))
            n += 1
    assert n == 71 + 202


def test_levels_at_every_separable_block():
    for layer, c_out in (MOBILENET_V2_SEPARABLE
                         + EFFICIENTNET_V2_K7_SEPARABLE):
        shape = SeparableShape(b=8, h=layer.h, w=layer.w, c_in=layer.c,
                               c_out=c_out, k=layer.k, s=layer.s)
        sch = get_fused_schedule(8, layer.h, layer.w, layer.c, c_out,
                                 layer.k, layer.s)
        compulsory = 4 * (shape.b * shape.h * shape.w * shape.c_in
                          + shape.k ** 2 * shape.c_in
                          + shape.c_in * shape.c_out
                          + shape.b * shape.out_h * shape.out_w * c_out)
        _check_levels(separable_hopper_traffic(shape, sch), compulsory)


def test_fused_below_staged_at_every_block():
    """The gate's claim at the Hopper level: at batch 8 and each family's
    published side, the fused route's device-memory bytes are below the
    staged model's at all 71 blocks and all 19 separable rows."""
    for fam in kb.FAMILY_CHOICES:
        _, rows, schedules = kb.family_chain(fam, kb.BATCH,
                                             kb.FAMILY_RES[fam])
        for r, sch in zip(rows, schedules):
            staged = kb.block_traffic(r, sch, kb.BATCH)[1].total_bytes
            assert kb.hopper_traffic(r, sch, kb.BATCH).dram_bytes < staged


# The solver's picks at batch 8 (B0 and V3-Large at 224, V2-S at 384,
# MobileNet-V2's separable blocks at 224), taken before the Hopper model
# was written: (tile_h, tile_w, mode or B5's chunk and C_in chunk, or the
# separable c_out tile and splits, copied-model bytes).
PINNED = {
    "b0": [(8, 8, 'recompute', 39189152), (8, 8, 'retain', 42496528),
           (8, 8, 'recompute', 40241880), (7, 4, 'retain', 30592088),
           (7, 7, 'retain', 37597160), (7, 3, 'retain', 17995880),
           (7, 7, 'retain', 24469200), (7, 7, 'retain', 24469200),
           (7, 7, 'retain', 32042704), (7, 7, 'retain', 53309424),
           (7, 7, 'retain', 53309424), (7, 2, 'retain', 30659440),
           (7, 7, 'retain', 42372288), (7, 7, 'retain', 42372288),
           (7, 7, 'retain', 42372288), (7, 7, 'retain', 41614528)],
    "v3l": [(8, 8, 'recompute', 14616448), (8, 8, 'recompute', 16265984),
            (8, 8, 'recompute', 11877600), (7, 4, 'retain', 15797816),
            (7, 7, 'retain', 19300360), (7, 7, 'retain', 19300360),
            (7, 3, 'retain', 17906560), (7, 7, 'retain', 24221760),
            (7, 5, 'retain', 22324160), (7, 5, 'retain', 22324160),
            (7, 7, 'retain', 27834064), (7, 7, 'retain', 45094896),
            (7, 2, 'retain', 29448048), (7, 4, 'retain', 29749920),
            (7, 4, 'retain', 29749920)],
    "v2s": [(8, 16, 24, 24, 64622592), (8, 16, 24, 24, 64622592),
            (8, 12, 48, 24, 197793792), (8, 16, 48, 48, 239321088),
            (8, 16, 48, 48, 239321088), (8, 16, 48, 48, 239321088),
            (8, 8, 64, 48, 191361024), (6, 8, 64, 64, 119537664),
            (6, 8, 64, 64, 119537664), (6, 8, 64, 64, 119537664),
            (6, 4, 'retain', 68711488)]
           + [(12, 6, 'retain', 98654336)] * 5
           + [(12, 6, 'retain', 161793152)]
           + [(12, 6, 'retain', 224175520)] * 8
           + [(6, 4, 'retain', 144991648)]
           + [(12, 6, 'retain', 146485504)] * 14,
    "mbv2": [(16, 4, 16, 1, 21153664), (8, 2, 24, 1, 43806336),
             (8, 8, 24, 1, 21249984), (8, 2, 32, 1, 18757888),
             (9, 7, 32, 3, 9038848), (9, 7, 32, 3, 9038848),
             (8, 2, 64, 2, 6571520), (8, 2, 64, 4, 4557824),
             (8, 2, 64, 4, 4557824), (8, 2, 64, 4, 4557824),
             (8, 4, 48, 3, 4856832), (8, 4, 48, 4, 6984192),
             (8, 4, 48, 4, 6984192), (4, 4, 32, 3, 11024384),
             (7, 4, 32, 5, 5911040), (7, 4, 32, 5, 5911040),
             (4, 4, 64, 2, 13120000)],
}


# the pinned fields of each schedule kind (the mesh terms the schedules
# also carry are the single-card ones here: tests/test_torch_layout_solver.py)
_PINNED_FIELDS = {
    MBConvSchedule: ("tile_h", "tile_w", "mode", "total_bytes"),
    FusedMBSchedule: ("tile_h", "tile_w", "chunk", "ci_chunk", "total_bytes"),
    FusedSchedule: ("tile_h", "tile_w", "co_tile", "splits", "total_bytes"),
}


def _fields(sch):
    return tuple(getattr(sch, f) for f in _PINNED_FIELDS[type(sch)])


@pytest.mark.parametrize("family", list(PINNED))
def test_solver_picks_are_pinned(family):
    """All 88 picks (71 MBConv / Fused-MBConv, 17 separable) unchanged."""
    if family == "mbv2":
        got = [_fields(get_fused_schedule(8, layer.h, layer.w, layer.c,
                                          c_out, layer.k, layer.s))
               for layer, c_out in MOBILENET_V2_SEPARABLE]
    else:
        got = [_fields(sch) for sch in kb.family_chain(
            family, 8, kb.FAMILY_RES[family])[2]]
    assert got == PINNED[family]
