"""CIM macro model and the BIG/LITTLE scheduler (Sec. III-B of the paper).

The macro: 64 tiles, each with a 180-word (8-bit) Tile Memory (TM, stationary
operand) and a 180-word Tile Register File (TRF, streaming operand).  The
paper's worked numbers all use the 180-word capacity (``T_w = floor(180/k_h)``
= 60 for k_h = 3; ``N_ch = 2`` for a 24-wide 128-channel ifmap), so that is
the capacity this model uses.  (Table I lists 11.25 KiB per TM/TRF — the
physical SRAM array including bit-serial planes; the *dataflow-visible*
capacity is 180 words, per Secs. II-III.)

``plan_layer`` turns one DWConv layer into a static execution plan:

* BIG scheduler (W > T_w): each tile hosts one channel's ``k_h x strip``
  sub-ifmap; the width is tiled into ConvDK strips; kernels are duplicated
  across idle tiles (``floor(N_tile / jobs)`` extra copies) to split rows.
* LITTLE scheduler (W <= T_w): ``N_ch`` channels share one TRF so the TM
  stays full; each tile serves ``N_ch`` channels per compute cycle round.

A copy of ``repro.core.tiling`` (the port imports nothing of the JAX
package).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Literal, Tuple

from .schedule import (
    ConvDKConditionError,
    ConvDKSchedule,
    duplication_number,
    make_schedule,
)


@dataclass(frozen=True)
class MacroConfig:
    """Hardware constants of the CIM macro (paper Secs. II, IV, Table I)."""

    n_tiles: int = 64
    tm_words: int = 180          # stationary words per tile (8-bit each)
    trf_words: int = 180         # streaming words per tile
    ib_bytes: int = 16 * 1024    # input buffer
    ob_bytes: int = 16 * 1024    # output buffer
    wb_bytes: int = 4 * 1024     # weight buffer
    clk_hz: float = 250e6        # 250 MHz
    clks_per_compute: int = 10   # pipelined 8-bit bit-serial MAC (Sec. IV-D)
    # energy constants (Sec. V-C), pJ/bit
    e_dram_pj: float = 20.0
    e_buffer_pj: float = 1.139
    e_tm_write_pj: float = 0.017
    e_trf_write_pj: float = 0.028
    dram_bw_gbps: float = 25.6   # DDR4-3200

    def t_w(self, k_h: int) -> int:
        return self.trf_words // k_h


@dataclass(frozen=True)
class DWLayer:
    """One depthwise-conv layer: C channels, HxW ifmap, k x k kernel, stride s.

    SAME padding throughout (the five models use 'same' convs).
    """

    c: int
    h: int
    w: int
    k: int
    s: int

    @property
    def out_h(self) -> int:
        return -(-self.h // self.s)

    @property
    def out_w(self) -> int:
        return -(-self.w // self.s)

    @property
    def padded_h(self) -> int:
        return (self.out_h - 1) * self.s + self.k

    @property
    def padded_w(self) -> int:
        return (self.out_w - 1) * self.s + self.k

    @property
    def macs(self) -> int:
        return self.c * self.out_h * self.out_w * self.k * self.k

    @property
    def ifmap_words(self) -> int:
        return self.c * self.h * self.w

    @property
    def ofmap_words(self) -> int:
        return self.c * self.out_h * self.out_w

    @property
    def kernel_words(self) -> int:
        return self.c * self.k * self.k


@dataclass(frozen=True)
class StripSpec:
    """One ConvDK strip across the width: schedule + output columns covered."""

    sched: ConvDKSchedule
    out_cols: int  # outputs taken from this strip (<= sched.out_len)


@dataclass(frozen=True)
class LayerPlan:
    """Static BIG/LITTLE execution plan for one layer on the macro."""

    layer: DWLayer
    mode: Literal["BIG", "LITTLE"]
    n_ch: int                   # channels per tile (1 for BIG)
    strips: Tuple[StripSpec, ...]
    tile_dup: int               # kernel copies across idle tiles (>= 1)
    jobs: int                   # (channel x strip) jobs before duplication
    rounds: int                 # sequential tile-assignment rounds
    tm_rows_used: int           # stationary rows occupied per tile
    tiles_active: int           # tiles busy in the steady state

    @property
    def tm_utilization(self) -> float:
        return self.tm_rows_used / 180.0

    @property
    def strip_out_total(self) -> int:
        return sum(sp.out_cols for sp in self.strips)


def _plan_strips(k: int, s: int, out_w: int, n_cap: int) -> Tuple[StripSpec, ...]:
    """Tile the output width into ConvDK strips of at most ``n_cap`` blocks.

    The last strip is sized to the remaining outputs (smaller N), mirroring a
    real scheduler that does not fetch a full-width halo for a 2-column tail.
    """
    strips: List[StripSpec] = []
    remaining = out_w
    while remaining > 0:
        sched = make_schedule(k, s, n_cap)
        if sched.out_len >= remaining:
            # tail strip: smallest N whose out_len covers the remainder
            n_tail = n_cap
            while n_tail > 1:
                cand = make_schedule(k, s, n_tail - 1)
                if cand.out_len >= remaining:
                    n_tail -= 1
                    sched = cand
                else:
                    break
            strips.append(StripSpec(sched=sched, out_cols=remaining))
            remaining = 0
        else:
            strips.append(StripSpec(sched=sched, out_cols=sched.out_len))
            remaining -= sched.out_len
    return tuple(strips)


def plan_layer(layer: DWLayer, macro: MacroConfig = MacroConfig()) -> LayerPlan:
    """BIG/LITTLE scheduling decision + static plan for one DWConv layer.

    Both regimes share the strip machinery; they differ in channel packing:

    * BIG  (padded W > T_w): strips fill the TRF, one channel per tile
      (``n_ch = 1``); kernels are duplicated over idle tiles.
    * LITTLE (padded W <= T_w): the strip is the (padded) full width and
      ``n_ch = floor(TRF / (k_h * ia_len))`` channels are concatenated in one
      TRF so the TM stays full (Fig. 4(c)-(d); Fig. 5's N_ch = 2 example).
    """
    k, s = layer.k, layer.s
    t_w = macro.t_w(k)
    w_pad = layer.padded_w

    n_cap = duplication_number(k, s, w_pad, t_w)
    if n_cap < 1:
        raise ConvDKConditionError(f"TRF too small for {layer}")
    strips = _plan_strips(k, s, layer.out_w, n_cap)
    mode: Literal["BIG", "LITTLE"] = "BIG" if w_pad > t_w else "LITTLE"

    ia_main = strips[0].sched.ia_len
    n_ch = max(1, macro.trf_words // (k * ia_main)) if mode == "LITTLE" else 1

    jobs = math.ceil(layer.c / n_ch) * len(strips)
    tile_dup = max(1, macro.n_tiles // jobs)
    rounds = math.ceil(jobs / macro.n_tiles)
    if mode == "LITTLE":
        # Fig. 4(c): channel strips are CONCATENATED in the TRF; leftover
        # columns host a partial next-channel segment at block granularity
        # (a channel may split across tiles, as BIG strips already do).
        l = strips[0].sched.l
        leftover = t_w - n_ch * ia_main
        bonus_blocks = max(0, (leftover - (l - 1)) // k)
        tm_rows = min(
            macro.tm_words,
            (n_ch * strips[0].sched.N + bonus_blocks) * k * k,
        )
    else:
        tm_rows = min(macro.tm_words, strips[0].sched.N * k * k)
    active = min(jobs * tile_dup, macro.n_tiles)
    return LayerPlan(
        layer=layer, mode=mode, n_ch=n_ch, strips=strips,
        tile_dup=tile_dup, jobs=jobs, rounds=rounds,
        tm_rows_used=tm_rows, tiles_active=active,
    )


def baseline_ws_utilization(layer: DWLayer) -> float:
    """Conventional WS: one vectorized k x k kernel per tile column."""
    return (layer.k * layer.k) / 180.0


def baseline_is_utilization(layer: DWLayer, macro: MacroConfig = MacroConfig()) -> float:
    """IS (Morphable-CIM-like): a k_h x W sub-ifmap is stationary in the TM;
    utilization is capped by the ifmap strip size (Sec. V-A: 'constrained by
    the ifmap size')."""
    return min(layer.k * layer.padded_w, macro.tm_words) / macro.tm_words
