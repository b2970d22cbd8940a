"""The paper's CIM dataflow cost model, and the HBM traffic model of the
separable, MBConv and Fused-MBConv pipelines on the card.

A copy of ``repro.core.perfmodel`` (the port imports nothing of the JAX
package), in two halves:

* **The CIM model** (Sec. V of the paper): traffic, energy and latency of
  one DWConv layer, and of a network, under the four dataflows — WS
  baseline, IS baseline, WS ConvDK, IS ConvDK — on the macro of
  ``core.tiling`` (``cost_ws_base`` ... ``compare_networks``,
  ``reduction``).  The same Python arithmetic in the same order as the
  JAX package's, so its numbers are equal, not close.
* **The HBM traffic model**: ``SeparableShape``, ``MBConvShape``,
  ``HBMTraffic``, ``pick_channel_block``, the staged and fused separable
  traffic, the per-pass / whole-block traffic of the retain and recompute
  modes, the single-pass Fused-MBConv traffic, and the staged MBConv and
  Fused-MBConv baselines, all under the strip-staged (DMA) input
  residency the JAX package defaults to and the Hopper kernels match.
  The separable and Fused-MBConv tile_h and the retain/recompute choice
  of ``core.autotune`` are priced here.

* **The mesh half**: ``ShardedTraffic`` and the per-device and
  collective pricing of the separable, MBConv and Fused-MBConv blocks
  partitioned over a ("data", "model") mesh (``shard_factors`` ...
  ``sharded_fusedmb_staged_traffic``), the layout transitions between
  blocks, and the per-pass split the cross-block overlap reads
  (``MBConvPassCosts`` ... ``overlap_saving_us``).
* **The calibration**: ``PerfCoefficients``, ``fit_perf_coefficients``
  and ``predict_walltime_us``, which fit measured wall time onto modeled
  bytes and staging issues (``benchmarks.roofline_bench --bench``).

The HBM model counts full-width row strips at a channel block: it does not
price the tiles the Hopper kernels run.  ``core.hopper_traffic`` does; the
gates of ``benchmarks.kernel_bench`` read it, while the solver still ranks
by this model.

CIM model accounting rules (each rule cites the paper sentence it encodes):

* **Traffic words** — 8-bit words crossing a buffer port.
  - IB side: ifmap words into the tile array (TRF for WS, TM for IS).
  - WB side: weight words into the tile array (TM for WS, TRF for IS).
  - OB side: ofmap words out of the accumulators.
* **Latency clocks** (Sec. IV-D):
  - TRF strip write = 1 clk per load event, tiles in parallel ("All TRFs are
    loaded ... at a single write cycle").
  - TM writes are word-by-word, 1 clk/word per tile; kernel duplication costs
    one extra clk per duplicated word ("9 cycles for the original weights and
    one additional cycle per duplicated weight" -> 2*k^2 for a duplicated 3x3).
  - OB write = 1 clk per 64-wide output round.
  - Compute = 10 clks per compute cycle (pipelined bit-serial 8-bit MAC);
    each compute cycle retires one output element per active tile.
  - DRAM traffic is pipelined behind compute (checked, flagged if it is not).
* **Energy** (Sec. V-C): DRAM 20 pJ/bit; IB/WB/OB SRAM access 1.139 pJ/bit;
  TM write 0.017 pJ/bit; TRF write 0.028 pJ/bit.  Physical TM/TRF bits
  written include duplicated copies; buffer-port energy counts unique words.

Interpretation choices (under-specified in the paper, fixed here as in
the JAX package):

1. WS-baseline TRF loads carry the k_h*k_w patch per output element with no
   inter-output reuse (the under-utilization the paper criticizes).
2. ConvDK strips exploit *vertical halo reuse*: consecutive output rows of
   the same (channel, strip) job share k_h - s input rows already resident
   in the register file, so only s*ia_len fresh words are fetched per new
   row.  This is the "maximizing data reuse" that yields the paper's
   77-87 % buffer-traffic reduction; without it the ceiling is 1 - s/k.
3. Tiles run asynchronously: total compute clocks = total sub-cycles /
   64-way parallelism, with kernel duplication across idle tiles providing
   the parallel slack (Sec. III-B "duplicated over idle tiles").
4. The headline "buffer traffic" metric (Fig. 7(c)) counts the IB- and
   WB-side streams; OB words are identical across dataflows and are
   reported separately (they enter energy and latency regardless).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, Iterable, List, Tuple

from .tiling import (
    DWLayer,
    MacroConfig,
    baseline_is_utilization,
    baseline_ws_utilization,
    plan_layer,
)

Dataflow = str  # "ws_base" | "is_base" | "ws_convdk" | "is_convdk"
DATAFLOWS: Tuple[Dataflow, ...] = ("ws_base", "is_base", "ws_convdk", "is_convdk")


@dataclass
class LayerCost:
    """All accounting for one layer under one dataflow."""

    layer: DWLayer
    dataflow: Dataflow
    # traffic words (8-bit) per buffer port
    ib_words: int = 0
    wb_words: int = 0
    ob_words: int = 0
    # physical bits written into tile storage (includes duplicate copies)
    tm_write_words: int = 0
    trf_write_words: int = 0
    # DRAM words (same for all dataflows; loop-nest and buffers fixed)
    dram_words: int = 0
    # latency, clocks
    ib_clks: int = 0
    wb_clks: int = 0
    ob_clks: int = 0
    compute_cycles: int = 0   # x10 clks each
    # utilization of the stationary memory (TM), 0..1
    tm_utilization: float = 0.0

    @property
    def buffer_words(self) -> int:
        """Fig. 7(c) metric: input-side buffer streams (see module note 4)."""
        return self.ib_words + self.wb_words

    @property
    def buffer_words_all(self) -> int:
        return self.ib_words + self.wb_words + self.ob_words

    @property
    def buffer_clks(self) -> int:
        return self.ib_clks + self.wb_clks + self.ob_clks

    @property
    def compute_clks(self) -> int:
        return self.compute_cycles * 10

    @property
    def total_clks(self) -> int:
        return self.buffer_clks + self.compute_clks

    def energy_pj(self, m: MacroConfig) -> Dict[str, float]:
        dram = self.dram_words * 8 * m.e_dram_pj
        buf = (self.ib_words + self.wb_words + self.ob_words) * 8 * m.e_buffer_pj
        tm = self.tm_write_words * 8 * m.e_tm_write_pj
        trf = self.trf_write_words * 8 * m.e_trf_write_pj
        return {"dram": dram, "buffer": buf, "tm": tm, "trf": trf,
                "total": dram + buf + tm + trf}

    def latency_ns(self, m: MacroConfig) -> float:
        return self.total_clks / m.clk_hz * 1e9

    def dram_pipelined_ok(self, m: MacroConfig) -> bool:
        """Sec. IV-D: DRAM transfer must hide behind compute."""
        dram_ns = self.dram_words / (m.dram_bw_gbps * 1e9) * 1e9
        return dram_ns <= self.compute_clks / m.clk_hz * 1e9


def _dram_words(layer: DWLayer) -> int:
    return layer.ifmap_words + layer.kernel_words + layer.ofmap_words


def _p64(x: int, m: MacroConfig) -> int:
    """Ceil-divide by the tile count (64-way spatial parallelism)."""
    return math.ceil(x / m.n_tiles)


# ---------------------------------------------------------------------------
# WS baseline — conventional weight-stationary CIM dataflow
# ---------------------------------------------------------------------------

def cost_ws_base(layer: DWLayer, m: MacroConfig = MacroConfig()) -> LayerCost:
    k2 = layer.k * layer.k
    outs = layer.out_h * layer.out_w
    ch_rounds = math.ceil(layer.c / m.n_tiles)

    ib_words = layer.c * outs * k2          # k^2 patch per output, no reuse
    wb_words = layer.c * k2                 # weights written once, stationary
    ob_words = layer.ofmap_words

    return LayerCost(
        layer=layer, dataflow="ws_base",
        ib_words=ib_words, wb_words=wb_words, ob_words=ob_words,
        tm_write_words=wb_words, trf_write_words=ib_words,
        dram_words=_dram_words(layer),
        ib_clks=ch_rounds * outs,           # 1-clk parallel TRF strip writes
        wb_clks=ch_rounds * k2,             # word-by-word TM writes
        ob_clks=_p64(layer.ofmap_words, m),
        compute_cycles=ch_rounds * outs,    # 1 output / tile / compute cycle
        tm_utilization=baseline_ws_utilization(layer),
    )


# ---------------------------------------------------------------------------
# IS baseline — input-stationary (Morphable-CIM-like)
# ---------------------------------------------------------------------------

def cost_is_base(layer: DWLayer, m: MacroConfig = MacroConfig()) -> LayerCost:
    k, s = layer.k, layer.s
    k2 = k * k
    outs = layer.out_h * layer.out_w
    ch_rounds = math.ceil(layer.c / m.n_tiles)

    # IS baseline (Morphable-CIM-like): the IA row strip is stationary in the
    # TM, re-written word-by-word per output row with no halo reuse (Sec. V-B
    # / VI: "the TMs are frequently re-written word-by-word"); the WEIGHTS
    # stream through the TRF per output element — Fig. 7(d): "in the IS
    # baseline, the weight movement is dominant".
    ib_words = layer.c * layer.out_h * k * layer.padded_w
    wb_words = layer.c * outs * k2          # weight patch per output
    ob_words = layer.ofmap_words

    return LayerCost(
        layer=layer, dataflow="is_base",
        ib_words=ib_words, wb_words=wb_words, ob_words=ob_words,
        tm_write_words=ib_words, trf_write_words=wb_words,
        dram_words=_dram_words(layer),
        ib_clks=_p64(ib_words, m),          # word-by-word TM writes
        wb_clks=ch_rounds * outs,           # 1-clk TRF weight events
        ob_clks=_p64(layer.ofmap_words, m),
        compute_cycles=ch_rounds * outs,
        tm_utilization=baseline_is_utilization(layer, m),
    )


# ---------------------------------------------------------------------------
# ConvDK dataflows (WS and IS variants share the BIG/LITTLE plan)
# ---------------------------------------------------------------------------

def _convdk_common(layer: DWLayer, m: MacroConfig):
    plan = plan_layer(layer, m)
    k, s = layer.k, layer.s
    # fresh ifmap words per (channel, strip) job over all output rows:
    # k_h rows for the first output row, s new rows for each of the rest
    # (vertical halo reuse inside the register file; module note 2).
    row_factor = k + (layer.out_h - 1) * s
    ia_words_per_ch = sum(sp.sched.ia_len for sp in plan.strips) * row_factor
    ifmap_stream_words = layer.c * ia_words_per_ch
    # one output element per sub-cycle; async tile packing (module note 3)
    total_subcycles = layer.c * layer.out_h * sum(
        sp.sched.out_len for sp in plan.strips
    )
    compute_cycles = _p64(total_subcycles, m)
    # strip-load events: one per (tile job, output row)
    load_events = plan.jobs * layer.out_h
    return plan, ifmap_stream_words, compute_cycles, load_events


def cost_ws_convdk(layer: DWLayer, m: MacroConfig = MacroConfig()) -> LayerCost:
    plan, ifmap_words, compute_cycles, load_events = _convdk_common(layer, m)
    k2 = layer.k * layer.k
    dup_blocks = sum(sp.sched.N for sp in plan.strips)

    wb_words = layer.c * k2                 # unique weights read from WB once
    # physical TM bits include the N duplicated copies (multi-access write)
    tm_write_words = layer.c * dup_blocks * k2

    return LayerCost(
        layer=layer, dataflow="ws_convdk",
        ib_words=ifmap_words, wb_words=wb_words, ob_words=layer.ofmap_words,
        tm_write_words=tm_write_words, trf_write_words=ifmap_words,
        dram_words=_dram_words(layer),
        ib_clks=_p64(load_events, m),       # 1-clk parallel TRF strip writes
        # duplicated kernel write: 2*k^2 clks per assignment round (Sec. IV-B)
        wb_clks=plan.rounds * 2 * k2,
        ob_clks=_p64(layer.ofmap_words, m),
        compute_cycles=compute_cycles,
        tm_utilization=plan.tm_utilization,
    )


def cost_is_convdk(layer: DWLayer, m: MacroConfig = MacroConfig()) -> LayerCost:
    plan, ifmap_words, compute_cycles, load_events = _convdk_common(layer, m)
    k2 = layer.k * layer.k
    dup_blocks = sum(sp.sched.N for sp in plan.strips)

    # IS: the IA strip is stationary in the TM (word-by-word writes, with the
    # same vertical halo reuse); the DUPLICATED kernel sits in the TRF and is
    # loaded once per (channel, strip) job, staying resident across all rows.
    wb_words = plan.jobs * k2               # unique kernel words per job
    trf_write_words = plan.jobs * dup_blocks * k2

    return LayerCost(
        layer=layer, dataflow="is_convdk",
        ib_words=ifmap_words, wb_words=wb_words, ob_words=layer.ofmap_words,
        tm_write_words=ifmap_words, trf_write_words=trf_write_words,
        dram_words=_dram_words(layer),
        ib_clks=_p64(ifmap_words, m),       # word-by-word TM writes
        wb_clks=_p64(plan.jobs, m),         # 1-clk TRF weight events
        ob_clks=_p64(layer.ofmap_words, m),
        compute_cycles=compute_cycles,
        tm_utilization=plan.tm_utilization,
    )


COST_FNS: Dict[Dataflow, Callable[..., LayerCost]] = {
    "ws_base": cost_ws_base,
    "is_base": cost_is_base,
    "ws_convdk": cost_ws_convdk,
    "is_convdk": cost_is_convdk,
}


# ---------------------------------------------------------------------------
# Network-level aggregation (Figs. 7-8)
# ---------------------------------------------------------------------------

@dataclass
class NetworkCost:
    name: str
    dataflow: Dataflow
    layers: List[LayerCost] = field(default_factory=list)

    def _sum(self, attr: str) -> int:
        return sum(getattr(c, attr) for c in self.layers)

    @property
    def buffer_words(self) -> int:
        return self._sum("buffer_words")

    @property
    def buffer_words_all(self) -> int:
        return self._sum("buffer_words_all")

    @property
    def dram_words(self) -> int:
        return self._sum("dram_words")

    @property
    def buffer_clks(self) -> int:
        return self._sum("buffer_clks")

    @property
    def compute_clks(self) -> int:
        return self._sum("compute_clks")

    @property
    def total_clks(self) -> int:
        return self._sum("total_clks")

    def energy_pj(self, m: MacroConfig = MacroConfig()) -> Dict[str, float]:
        tot: Dict[str, float] = {"dram": 0.0, "buffer": 0.0, "tm": 0.0,
                                 "trf": 0.0, "total": 0.0}
        for c in self.layers:
            for key, v in c.energy_pj(m).items():
                tot[key] += v
        return tot

    def mean_tm_utilization(self) -> float:
        """Compute-cycle-weighted mean TM utilization (Fig. 7(a))."""
        num = sum(c.tm_utilization * c.compute_cycles for c in self.layers)
        den = sum(c.compute_cycles for c in self.layers)
        return num / den if den else 0.0

    def latency_ms(self, m: MacroConfig = MacroConfig()) -> float:
        return self.total_clks / m.clk_hz * 1e3


def evaluate_network(
    name: str,
    layers: Iterable[DWLayer],
    dataflow: Dataflow,
    macro: MacroConfig = MacroConfig(),
) -> NetworkCost:
    fn = COST_FNS[dataflow]
    net = NetworkCost(name=name, dataflow=dataflow)
    for layer in layers:
        net.layers.append(fn(layer, macro))
    return net


def compare_networks(
    name: str, layers: Iterable[DWLayer], macro: MacroConfig = MacroConfig()
) -> Dict[Dataflow, NetworkCost]:
    layers = list(layers)
    return {df: evaluate_network(name, layers, df, macro) for df in DATAFLOWS}


def reduction(base: float, ours: float) -> float:
    """Percent reduction vs a baseline (positive = we are smaller)."""
    return 100.0 * (1.0 - ours / base) if base else 0.0


# ---------------------------------------------------------------------------
# HBM traffic model of the pipelines on the card
# ---------------------------------------------------------------------------

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
    def padded_h(self) -> int:
        return (self.out_h - 1) * self.s + self.k

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


def mbconv_best_fused_traffic(
    shape: MBConvShape, tile_h: int, c_block: int = 128,
) -> Tuple[str, HBMTraffic]:
    """(mode, traffic) of the cheaper two-pass variant at this tile_h."""
    priced = [(m, mbconv_fused_traffic(shape, tile_h, m, c_block))
              for m in MBCONV_MODES]
    return min(priced, key=lambda mt: mt[1].total_bytes)


def mbconv_staged_traffic(
    shape: MBConvShape, tile_h: int, c_block: int = 128
) -> HBMTraffic:
    """HBM traffic of the staged MBConv pipeline (``kernels.convdk_mbconv.
    convdk_mbconv_staged``):

    1. expand PW: read x + w_exp, write the expanded map,
    2. stage_row_strips over the expanded map (halo rows duplicated),
    3. DW kernel: read strips + taps, write the DW output,
    4. SE (when the block has one): read the DW output for the pool, run
       the MLP, then re-read AND re-write the DW output applying the gate,
    5. projection PW: re-read the (scaled) DW output + w_proj, write out.

    The weight-stationary-baseline behaviour the paper criticizes: the
    squeeze forces the whole DW tensor through device memory four more
    times.  A no-SE block skips stage 4 entirely.
    """
    (_n_th, _n_cm, _n_co, _strips, e_rows, out, w_exp, w_dw, w_proj,
     pool) = _mbconv_common(shape, tile_h, c_block)
    x_words = shape.b * shape.h * shape.w * shape.c_in
    xe = shape.b * shape.h * shape.w * shape.c_mid
    xe_pad = shape.b * shape.padded_h * shape.padded_w * shape.c_mid
    n_th, in_rows = _strip_counts(shape, tile_h)
    strips_e = shape.b * n_th * in_rows * shape.padded_w * shape.c_mid
    reads = (x_words + w_exp                      # expand
             + xe_pad                             # staging read
             + strips_e + w_dw                    # DW kernel
             + e_rows + w_proj)                   # projection read
    writes = ((xe if shape.has_expand else 0)     # expanded map
              + strips_e                          # staged strips
              + e_rows                            # DW output
              + out)
    if shape.has_se:
        reads += (e_rows + shape.se_words         # SE pool + MLP params
                  + e_rows + pool)                # gate apply read
        writes += (pool                           # gate
                   + e_rows)                      # scaled DW output
    if not shape.has_expand:
        reads -= x_words                          # no expand stage: DW stages
    return HBMTraffic(reads, writes, shape.dtype_bytes)


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


def fusedmb_staged_traffic(
    shape: MBConvShape, tile_h: int, c_block: int = 128
) -> HBMTraffic:
    """HBM traffic of the staged Fused-MBConv pipeline
    (``kernels.convdk_fusedmb.convdk_fusedmb_staged``):

    1. dense conv: read the input + w_conv, write the expanded map,
    2. projection PW: re-read the expanded map + w_proj, write out.

    The expanded map makes the round trip the fusion deletes."""
    _require_no_se(shape)
    del tile_h, c_block
    x_words = shape.b * shape.h * shape.w * shape.c_in
    xe = shape.b * shape.out_h * shape.out_w * shape.c_mid
    out = shape.b * shape.out_h * shape.out_w * shape.c_out
    w_conv = shape.k * shape.k * shape.c_in * shape.c_mid
    w_proj = shape.c_mid * shape.c_out
    reads = x_words + w_conv + xe + w_proj
    writes = xe + out
    return HBMTraffic(reads, writes, shape.dtype_bytes)


# ---------------------------------------------------------------------------
# Sharded traffic: per-device bytes and collective words
#
# ``kernels.convdk_sharded`` partitions the fused pipelines over the
# ("data", "model") mesh of ``launch.mesh`` (a "pod" axis folds into the
# data factor): batch on "data" for every family, c_out on "model" for the
# separable block (collective-free: its c_in reduction is local) and c_mid
# on "model" for MBConv and Fused-MBConv (the SE squeeze and the projection
# reduce over the whole expanded width, so each becomes a reduction across
# the model group).  Per-device traffic is the single-device model at the
# shard shape; collective words follow the schedule's collective:
#
# * ``ring_allreduce``: 2*(mp-1) words per reduced word per model group
#   (reduce-scatter + all-gather; the result lands replicated);
# * ``psum_scatter`` (the projection only): (mp-1) words per reduced word,
#   the output leaving c_out-sharded, padded to the model factor.  The SE
#   squeeze always rings: the excite FC needs it replicated.
#
# Words are summed over the dp model groups; an axis that does not divide
# its grid drops the whole layer to (1, 1).  The same arithmetic, in the
# same order, as ``repro.core.perfmodel``'s mesh half, at the strip-staged
# residency this module fixes.
# ---------------------------------------------------------------------------

MeshShape = Tuple[int, int]     # ("data", "model") factors, (1, 1) = 1 card

COLLECTIVE_MODES: Tuple[str, ...] = ("ring_allreduce", "psum_scatter")
DEFAULT_COLLECTIVE = "ring_allreduce"

# How a block's activation sits across the "model" group at a block
# boundary: ``replicated`` (every device holds its data group's whole
# (B_local, H, W, C) slice) or ``model_sharded`` (the channels split over
# "model": what a psum_scatter exit leaves, and what an identity-expand
# MBConv or a sharded-c_in separable entry consumes collective-free).
LAYOUT_MODES: Tuple[str, ...] = ("replicated", "model_sharded")
DEFAULT_LAYOUT = "replicated"


def validate_collective(collective: str) -> str:
    if collective not in COLLECTIVE_MODES:
        raise ValueError(
            f"collective must be one of {COLLECTIVE_MODES}, "
            f"got {collective!r}")
    return collective


def validate_layout(layout: str) -> str:
    if layout not in LAYOUT_MODES:
        raise ValueError(
            f"layout must be one of {LAYOUT_MODES}, got {layout!r}")
    return layout


@dataclass(frozen=True)
class ShardedTraffic:
    """One fused block under one (data, model) partitioning."""

    device: HBMTraffic           # traffic of ONE device's shard
    collective_words: int        # interconnect words, summed over the mesh
    n_devices: int
    mesh_shape: MeshShape = (1, 1)
    collective: str = DEFAULT_COLLECTIVE   # reduction layout priced above
    in_layout: str = DEFAULT_LAYOUT        # how the input arrives
    transition_words: int = 0    # entry-side layout repay (all-gather words)

    @property
    def dtype_bytes(self) -> int:
        return self.device.dtype_bytes

    @property
    def per_device_bytes(self) -> int:
        return self.device.total_bytes

    @property
    def collective_bytes(self) -> int:
        return self.collective_words * self.dtype_bytes

    @property
    def transition_bytes(self) -> int:
        return self.transition_words * self.dtype_bytes

    @property
    def out_layout(self) -> str:
        """The layout the output leaves in: c_out-sharded after a
        psum_scatter, replicated otherwise."""
        _dp, mp = self.mesh_shape
        if mp > 1 and self.collective == "psum_scatter":
            return "model_sharded"
        return DEFAULT_LAYOUT

    @property
    def total_bytes(self) -> int:
        """Every device's bytes plus the interconnect words (reductions and
        any entry-side layout repay)."""
        return (self.device.total_bytes * self.n_devices
                + self.collective_bytes + self.transition_bytes)


def shard_factors(batch: int, channels: int,
                  mesh_shape: MeshShape) -> MeshShape:
    """Effective (data, model) split, as ``kernels.can_shard_fused`` routes:
    all or nothing, so a layer either axis does not divide prices (and
    runs) as (1, 1)."""
    dp, mp = mesh_shape
    if dp < 1 or mp < 1 or batch % dp != 0 or channels % mp != 0:
        return 1, 1
    return dp, mp


def separable_shard(
    shape: SeparableShape, mesh_shape: MeshShape,
    in_layout: str = DEFAULT_LAYOUT,
) -> Tuple[SeparableShape, MeshShape]:
    """(per-device shard shape, effective factors) of the separable block:
    batch over "data", and c_out over "model" for a replicated input or
    c_in over "model" for a model-sharded one."""
    validate_layout(in_layout)
    if in_layout == "model_sharded":
        dp, mp = shard_factors(shape.b, shape.c_in, mesh_shape)
        if mp > 1:
            return replace(shape, b=shape.b // dp,
                           c_in=shape.c_in // mp), (dp, mp)
        return replace(shape, b=shape.b // dp), (dp, mp)
    dp, mp = shard_factors(shape.b, shape.c_out, mesh_shape)
    return replace(shape, b=shape.b // dp, c_out=shape.c_out // mp), (dp, mp)


def can_shard_input(shape: MBConvShape, mesh_shape: MeshShape) -> bool:
    """True iff the MBConv block consumes a c_in-sharded input with no entry
    collective: only an identity expand (c_mid == c_in) does, its slice of
    c_in being exactly its slice of c_mid."""
    _dp, mp = shard_factors(shape.b, shape.c_mid, mesh_shape)
    return mp > 1 and not shape.has_expand


def mbconv_shard(
    shape: MBConvShape, mesh_shape: MeshShape,
    in_layout: str = DEFAULT_LAYOUT,
) -> Tuple[MBConvShape, MeshShape]:
    """(per-device shard shape, effective factors) of the MBConv block:
    batch over "data", c_mid over "model", and c_in with it for a
    model-sharded input to an identity expand."""
    validate_layout(in_layout)
    dp, mp = shard_factors(shape.b, shape.c_mid, mesh_shape)
    local = replace(shape, b=shape.b // dp, c_mid=shape.c_mid // mp)
    if in_layout == "model_sharded" and mp > 1 and not shape.has_expand:
        local = replace(local, c_in=shape.c_in // mp)
    return local, (dp, mp)


def scatter_c_out(c_out: int, mp: int) -> int:
    """Channel width a psum_scatter moves: c_out rounded up to the model
    factor (the padding columns are zero projection columns)."""
    if mp <= 1:
        return c_out
    return _round_up(c_out, mp)


def _separable_collective_words(shape: SeparableShape, dp: int, mp: int,
                                collective: str) -> int:
    """Words of the sharded-c_in separable form: the pointwise partial over
    each device's c_in rows, reduced across the model group per
    ``collective``."""
    validate_collective(collective)
    if mp <= 1:
        return 0
    b_local = shape.b // dp
    out = b_local * shape.out_h * shape.out_w * shape.c_out
    if collective == "psum_scatter":
        return dp * (mp - 1) * (b_local * shape.out_h * shape.out_w
                                * scatter_c_out(shape.c_out, mp))
    return dp * 2 * (mp - 1) * out


def sharded_separable_traffic(
    shape: SeparableShape, tile_h: int, mesh_shape: MeshShape = (1, 1),
    c_block: int = 128, in_layout: str = DEFAULT_LAYOUT,
    collective: str = DEFAULT_COLLECTIVE,
) -> ShardedTraffic:
    """Per-device traffic of the sharded fused separable block: collective
    free for a replicated input (c_out on "model"); for a model-sharded
    input (c_in on "model") each device reads its slice and the pointwise
    partial reduces per ``collective``."""
    validate_layout(in_layout)
    local, (dp, mp) = separable_shard(shape, mesh_shape, in_layout)
    if in_layout == "model_sharded" and mp > 1:
        return ShardedTraffic(
            device=fused_separable_traffic(local, tile_h, c_block),
            collective_words=_separable_collective_words(
                shape, dp, mp, collective),
            n_devices=dp * mp, mesh_shape=(dp, mp), collective=collective,
            in_layout=in_layout)
    return ShardedTraffic(
        device=fused_separable_traffic(local, tile_h, c_block),
        collective_words=0, n_devices=dp * mp, mesh_shape=(dp, mp))


def sharded_separable_staged_traffic(
    shape: SeparableShape, tile_h: int, mesh_shape: MeshShape = (1, 1),
) -> ShardedTraffic:
    """The staged separable pipeline under the same partitioning (its
    pointwise reduction is c_in-local too: collective-free)."""
    local, (dp, mp) = separable_shard(shape, mesh_shape)
    return ShardedTraffic(
        device=staged_separable_traffic(local, tile_h),
        collective_words=0, n_devices=dp * mp, mesh_shape=(dp, mp))


def can_psum_scatter(shape: MBConvShape, mesh_shape: MeshShape) -> bool:
    """True iff the psum_scatter exit runs at this partitioning: the layer
    shards on "model" (a c_out the factor does not divide pads)."""
    _dp, mp = shard_factors(shape.b, shape.c_mid, mesh_shape)
    return mp > 1


def layout_transition_words(
    b: int, h: int, w: int, c: int, mesh_shape: MeshShape,
    producer_layout: str, consumer_layout: str,
) -> int:
    """Words to move a (b, h, w, c) activation from the producer's boundary
    layout to the consumer's: an all-gather of the missing (mp-1)/mp
    slices per model group (summed over the dp groups) where a sharded
    output feeds a replicated entry; free otherwise (a replicated output
    feeding a sharded entry slices locally)."""
    validate_layout(producer_layout)
    validate_layout(consumer_layout)
    dp, mp = mesh_shape
    if (mp <= 1 or producer_layout != "model_sharded"
            or consumer_layout == "model_sharded"):
        return 0
    b_local = b // dp if dp > 1 and b % dp == 0 else b
    # (mp-1) words per gathered word per group: scatter + gather == ring
    return dp * (mp - 1) * b_local * h * w * scatter_c_out(c, mp)


def _mbconv_entry_transition_words(shape: MBConvShape, dp: int, mp: int,
                                   in_layout: str) -> int:
    """Entry-side all-gather where a c_in-sharded input feeds a real expand
    (dense over all of c_in); zero for the identity expand and for
    replicated arrivals."""
    if mp <= 1 or in_layout != "model_sharded" or not shape.has_expand:
        return 0
    b_local = shape.b // dp
    return dp * (mp - 1) * b_local * shape.h * shape.w * shape.c_in


def _mbconv_collective_split(
    shape: MBConvShape, dp: int, mp: int,
    collective: str = DEFAULT_COLLECTIVE,
) -> Tuple[int, int]:
    """Mesh-wide ``(squeeze, projection)`` words: the (B_local, C_se) SE
    squeeze partial rings (pass 1: the gate waits on it); the (B_local,
    H', W', C_out) projection partial rings or reduce-scatters (pass 2)."""
    validate_collective(collective)
    if mp <= 1:
        return 0, 0
    b_local = shape.b // dp
    squeeze = b_local * shape.c_se          # 0 for a block without SE
    proj = b_local * shape.out_h * shape.out_w * shape.c_out
    if collective == "psum_scatter":
        proj_words = (mp - 1) * (b_local * shape.out_h * shape.out_w
                                 * scatter_c_out(shape.c_out, mp))
    else:
        proj_words = 2 * (mp - 1) * proj
    return dp * 2 * (mp - 1) * squeeze, dp * proj_words


def _mbconv_collective_words(shape: MBConvShape, dp: int, mp: int,
                             collective: str = DEFAULT_COLLECTIVE) -> int:
    """The two c_mid reductions' words: ``_mbconv_collective_split``
    summed."""
    squeeze, proj = _mbconv_collective_split(shape, dp, mp, collective)
    return squeeze + proj


def sharded_mbconv_traffic(
    shape: MBConvShape, tile_h: int, mode: str = "retain",
    mesh_shape: MeshShape = (1, 1), c_block: int = 128,
    collective: str = DEFAULT_COLLECTIVE,
    in_layout: str = DEFAULT_LAYOUT,
) -> ShardedTraffic:
    """Per-device traffic and collective words of the sharded two-pass
    MBConv: batch over "data", c_mid over "model", the SE squeeze and the
    projection reduced across the model group.  ``in_layout`` prices the
    entry: an identity expand takes a model-sharded input free (c_in shards
    with c_mid), a real expand gathers it back (``transition_words``)."""
    validate_layout(in_layout)
    local, (dp, mp) = mbconv_shard(shape, mesh_shape, in_layout)
    eff_layout = in_layout if mp > 1 else DEFAULT_LAYOUT
    return ShardedTraffic(
        device=mbconv_fused_traffic(local, tile_h, mode, c_block),
        collective_words=_mbconv_collective_words(shape, dp, mp, collective),
        n_devices=dp * mp, mesh_shape=(dp, mp), collective=collective,
        in_layout=eff_layout,
        transition_words=_mbconv_entry_transition_words(
            shape, dp, mp, eff_layout))


def sharded_mbconv_staged_traffic(
    shape: MBConvShape, tile_h: int, mesh_shape: MeshShape = (1, 1),
    c_block: int = 128, collective: str = DEFAULT_COLLECTIVE,
    in_layout: str = DEFAULT_LAYOUT,
) -> ShardedTraffic:
    """The staged MBConv pipeline under the same partitioning: the same
    collectives and entry, so fused against staged stays a comparison of
    device bytes."""
    validate_layout(in_layout)
    local, (dp, mp) = mbconv_shard(shape, mesh_shape, in_layout)
    eff_layout = in_layout if mp > 1 else DEFAULT_LAYOUT
    return ShardedTraffic(
        device=mbconv_staged_traffic(local, tile_h, c_block),
        collective_words=_mbconv_collective_words(shape, dp, mp, collective),
        n_devices=dp * mp, mesh_shape=(dp, mp), collective=collective,
        in_layout=eff_layout,
        transition_words=_mbconv_entry_transition_words(
            shape, dp, mp, eff_layout))


def fusedmb_shard(
    shape: MBConvShape, mesh_shape: MeshShape,
) -> Tuple[MBConvShape, MeshShape]:
    """(per-device shard shape, effective factors) of the Fused-MBConv
    block: batch over "data", c_mid over "model"; c_in never shards (the
    dense conv contracts over all of it)."""
    _require_no_se(shape)
    dp, mp = shard_factors(shape.b, shape.c_mid, mesh_shape)
    return replace(shape, b=shape.b // dp, c_mid=shape.c_mid // mp), (dp, mp)


def _fusedmb_collective_words(shape: MBConvShape, dp: int, mp: int,
                              collective: str) -> int:
    """The Fused-MBConv's one reduction, the projection partial, priced as
    MBConv's."""
    validate_collective(collective)
    if mp <= 1:
        return 0
    b_local = shape.b // dp
    if collective == "psum_scatter":
        return dp * (mp - 1) * (b_local * shape.out_h * shape.out_w
                                * scatter_c_out(shape.c_out, mp))
    out = b_local * shape.out_h * shape.out_w * shape.c_out
    return dp * 2 * (mp - 1) * out


def _replicated_only(in_layout: str) -> None:
    validate_layout(in_layout)
    if in_layout != DEFAULT_LAYOUT:
        raise ValueError(
            f"fusedmb consumes replicated arrivals only, got {in_layout!r}")


def sharded_fusedmb_traffic(
    shape: MBConvShape, tile_h: int, mesh_shape: MeshShape = (1, 1),
    c_block: int = 128, collective: str = DEFAULT_COLLECTIVE,
    in_layout: str = DEFAULT_LAYOUT,
) -> ShardedTraffic:
    """Per-device traffic and collective words of the sharded Fused-MBConv
    (replicated input only: a sharded producer repays at the boundary)."""
    _replicated_only(in_layout)
    local, (dp, mp) = fusedmb_shard(shape, mesh_shape)
    return ShardedTraffic(
        device=fusedmb_fused_traffic(local, tile_h, c_block),
        collective_words=_fusedmb_collective_words(shape, dp, mp, collective),
        n_devices=dp * mp, mesh_shape=(dp, mp), collective=collective,
        in_layout=DEFAULT_LAYOUT)


def sharded_fusedmb_staged_traffic(
    shape: MBConvShape, tile_h: int, mesh_shape: MeshShape = (1, 1),
    c_block: int = 128, collective: str = DEFAULT_COLLECTIVE,
    in_layout: str = DEFAULT_LAYOUT,
) -> ShardedTraffic:
    """The staged Fused-MBConv pipeline under the same partitioning and
    collective."""
    _replicated_only(in_layout)
    local, (dp, mp) = fusedmb_shard(shape, mesh_shape)
    return ShardedTraffic(
        device=fusedmb_staged_traffic(local, tile_h, c_block),
        collective_words=_fusedmb_collective_words(shape, dp, mp, collective),
        n_devices=dp * mp, mesh_shape=(dp, mp), collective=collective,
        in_layout=DEFAULT_LAYOUT)


# ---------------------------------------------------------------------------
# Cross-block overlap: per-pass costs of a sharded block
#
# Pass 2 of block i and pass 1 of block i+1 touch disjoint buffers but the
# activation between them, so a chain executor may run the consumer's
# pass 1 beside the producer's pass 2; a pipelined boundary then costs
# max(pass2_us, pass1_us) instead of their sum.
# ---------------------------------------------------------------------------

OVERLAP_MODES: Tuple[str, ...] = ("serial", "pipelined")
DEFAULT_OVERLAP = "serial"


def validate_overlap(overlap: str) -> str:
    if overlap not in OVERLAP_MODES:
        raise ValueError(
            f"overlap must be one of {OVERLAP_MODES}, got {overlap!r}")
    return overlap


@dataclass(frozen=True)
class MBConvPassCosts:
    """One sharded block's costs split by pass: per-device traffic and the
    mesh-wide collective words each pass waits on (they sum to the block's
    ``ShardedTraffic``)."""

    pass1: HBMTraffic            # one device's pass-1 (+ SE MLP) traffic
    pass2: HBMTraffic            # one device's pass-2 traffic
    pass1_collective_words: int  # SE squeeze ring + any entry gather
    pass2_collective_words: int  # projection reduction (ring or scatter)

    @property
    def dtype_bytes(self) -> int:
        return self.pass1.dtype_bytes

    @property
    def pass1_collective_bytes(self) -> int:
        return self.pass1_collective_words * self.dtype_bytes

    @property
    def pass2_collective_bytes(self) -> int:
        return self.pass2_collective_words * self.dtype_bytes


def sharded_mbconv_pass_costs(
    shape: MBConvShape, tile_h: int, mode: str = "retain",
    mesh_shape: MeshShape = (1, 1), c_block: int = 128,
    collective: str = DEFAULT_COLLECTIVE,
    in_layout: str = DEFAULT_LAYOUT,
) -> MBConvPassCosts:
    """``sharded_mbconv_traffic`` split by pass: squeeze and any entry
    gather on pass 1, the projection reduction on pass 2."""
    validate_layout(in_layout)
    local, (dp, mp) = mbconv_shard(shape, mesh_shape, in_layout)
    eff_layout = in_layout if mp > 1 else DEFAULT_LAYOUT
    p1, p2 = mbconv_pass_traffic(local, tile_h, mode, c_block)
    squeeze, proj = _mbconv_collective_split(shape, dp, mp, collective)
    entry = _mbconv_entry_transition_words(shape, dp, mp, eff_layout)
    return MBConvPassCosts(pass1=p1, pass2=p2,
                           pass1_collective_words=squeeze + entry,
                           pass2_collective_words=proj)


def sharded_fusedmb_pass_costs(
    shape: MBConvShape, tile_h: int, mesh_shape: MeshShape = (1, 1),
    c_block: int = 128, collective: str = DEFAULT_COLLECTIVE,
    in_layout: str = DEFAULT_LAYOUT,
) -> MBConvPassCosts:
    """``sharded_fusedmb_traffic`` split by pass: the whole single-pass
    block, its collective too, on pass 1; pass 2 is zero."""
    _replicated_only(in_layout)
    local, (dp, mp) = fusedmb_shard(shape, mesh_shape)
    p1, p2 = fusedmb_pass_traffic(local, tile_h, c_block)
    proj = _fusedmb_collective_words(shape, dp, mp, collective)
    return MBConvPassCosts(pass1=p1, pass2=p2,
                           pass1_collective_words=proj,
                           pass2_collective_words=0)


# ---------------------------------------------------------------------------
# Measured calibration: fitting walltime coefficients onto the byte model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PerfCoefficients:
    """Least-squares fit of measured walltime onto the modeled cost terms.

    ``walltime_us ~ base_us + us_per_mb * bytes/1e6
                  + us_per_dma_issue * dma_issues
                  + us_per_collective_mb * collective_bytes/1e6``

    The two non-byte terms are the costs the byte model cannot see: the
    per-issue overhead of staging (on the card, one cp.async ring stage of
    one CTA: ``core.hopper_traffic``'s ``issues``) and the latency of a
    collective word relative to a device-memory word (0 where a sweep
    has no collectives, as on one card).  ``rms_us`` is the fit residual —
    report it next to the coefficients, a fit that explains nothing should
    not decide knobs.  Counterpart of ``repro.core.perfmodel``'s; its
    CPU-interpret default coefficients are not carried over.
    """

    base_us: float
    us_per_mb: float
    us_per_dma_issue: float
    us_per_collective_mb: float
    n_samples: int
    rms_us: float

    def as_dict(self) -> Dict[str, float]:
        return {
            "base_us": self.base_us,
            "us_per_mb": self.us_per_mb,
            "us_per_dma_issue": self.us_per_dma_issue,
            "us_per_collective_mb": self.us_per_collective_mb,
            "n_samples": self.n_samples,
            "rms_us": self.rms_us,
        }


def fit_perf_coefficients(samples: Iterable[dict]) -> PerfCoefficients:
    """Fit :class:`PerfCoefficients` from measured samples.

    Each sample is a dict with ``walltime_us`` and ``modeled_bytes``
    (required) plus optional ``dma_issues`` and ``collective_bytes``.
    Cost columns that are constant across the sample set are dropped
    from the regression (their coefficient is reported as 0.0 — the
    data cannot identify them), so a single-card sweep with no
    collectives still yields a well-posed byte/issue fit.
    """
    import numpy as np

    rows = [(float(s["walltime_us"]), float(s["modeled_bytes"]) / 1e6,
             float(s.get("dma_issues", 0)),
             float(s.get("collective_bytes", 0)) / 1e6)
            for s in samples]
    if not rows:
        raise ValueError("fit_perf_coefficients needs at least one sample")
    y = np.array([r[0] for r in rows])
    cols = {"us_per_mb": np.array([r[1] for r in rows]),
            "us_per_dma_issue": np.array([r[2] for r in rows]),
            "us_per_collective_mb": np.array([r[3] for r in rows])}
    active = [k for k, v in cols.items() if float(v.max() - v.min()) > 0]
    design = np.column_stack(
        [np.ones(len(rows))] + [cols[k] for k in active])
    if len(rows) < design.shape[1]:
        raise ValueError(
            f"fit needs >= {design.shape[1]} samples for "
            f"{design.shape[1]} free terms, got {len(rows)}")
    coef, *_ = np.linalg.lstsq(design, y, rcond=None)
    fitted = dict.fromkeys(cols, 0.0)
    for name, value in zip(active, coef[1:]):
        fitted[name] = float(value)
    rms = float(np.sqrt(np.mean((design @ coef - y) ** 2)))
    return PerfCoefficients(
        base_us=float(coef[0]), n_samples=len(rows), rms_us=rms, **fitted)


def predict_walltime_us(coeffs: PerfCoefficients, *, modeled_bytes: float,
                        dma_issues: float = 0,
                        collective_bytes: float = 0) -> float:
    """Walltime the calibrated model expects for one cost point."""
    return (coeffs.base_us
            + coeffs.us_per_mb * modeled_bytes / 1e6
            + coeffs.us_per_dma_issue * dma_issues
            + coeffs.us_per_collective_mb * collective_bytes / 1e6)


def mbconv_pass_us(coeffs: PerfCoefficients, traffic: HBMTraffic,
                   collective_words: int = 0) -> float:
    """Calibrated time of ONE pass, floored at zero (a fit may go negative
    at small extrapolated points; a pass never takes negative time)."""
    return max(0.0, predict_walltime_us(
        coeffs, modeled_bytes=traffic.total_bytes,
        dma_issues=traffic.dma_issues,
        collective_bytes=collective_words * traffic.dtype_bytes))


def boundary_overlap_us(pass2_us: float, pass1_us: float,
                        overlap: str = DEFAULT_OVERLAP) -> float:
    """Modeled time of one block boundary: the producer's pass 2 plus the
    consumer's pass 1 when serial, their max when pipelined."""
    validate_overlap(overlap)
    if overlap == "pipelined":
        return max(pass2_us, pass1_us)
    return pass2_us + pass1_us


def overlap_saving_us(pass2_us: float, pass1_us: float) -> float:
    """Time a pipelined boundary hides against a serial one."""
    return min(pass2_us, pass1_us)
