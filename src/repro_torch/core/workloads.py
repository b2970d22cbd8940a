"""Per-layer DWConv tables for the paper's five evaluation models, and the
full-block tables of the networks the port runs.

A copy of ``repro.core.workloads`` (the port imports nothing of the JAX
package).  All tables are the canonical 224x224-input configurations from
the respective papers:

* MobileNetV1  [arXiv:1704.04861, Table 1]
* MobileNetV2  [arXiv:1801.04381, Table 2]  (t = 6 expansion)
* MobileNetV3-Large / -Small  [arXiv:1905.02244, Tables 1-2]
* EfficientNet-B0  [arXiv:1905.11946, Table 1]

Each DW entry is the depthwise stage of a block: (channels of the
*expanded* tensor the DWConv runs on, ifmap H=W at that point, kernel k,
stride s).  Pointwise (1x1) convolutions are not listed there: the paper
evaluates DWConv dataflows only.  MobileNet-V2's 17 separable blocks (with
their pointwise widths) are the full-width separable shapes the fused
separable kernel is checked and timed on.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from .tiling import DWLayer


def _dw(c: int, hw: int, k: int, s: int) -> DWLayer:
    return DWLayer(c=c, h=hw, w=hw, k=k, s=s)


MOBILENET_V1: List[DWLayer] = [
    _dw(32, 112, 3, 1),
    _dw(64, 112, 3, 2),
    _dw(128, 56, 3, 1),
    _dw(128, 56, 3, 2),
    _dw(256, 28, 3, 1),
    _dw(256, 28, 3, 2),
    *[_dw(512, 14, 3, 1) for _ in range(5)],
    _dw(512, 14, 3, 2),
    _dw(1024, 7, 3, 1),
]

# MobileNetV2: expanded channels = t * c_in of the preceding block.
MOBILENET_V2: List[DWLayer] = [
    _dw(32, 112, 3, 1),     # first bottleneck, t = 1
    _dw(96, 112, 3, 2),     # 16 -> 24, t = 6
    _dw(144, 56, 3, 1),
    _dw(144, 56, 3, 2),     # 24 -> 32
    _dw(192, 28, 3, 1),
    _dw(192, 28, 3, 1),
    _dw(192, 28, 3, 2),     # 32 -> 64
    *[_dw(384, 14, 3, 1) for _ in range(3)],
    _dw(384, 14, 3, 1),     # 64 -> 96 stage (s = 1)
    _dw(576, 14, 3, 1),
    _dw(576, 14, 3, 1),
    _dw(576, 14, 3, 2),     # 96 -> 160
    _dw(960, 7, 3, 1),
    _dw(960, 7, 3, 1),
    _dw(960, 7, 3, 1),      # 160 -> 320 (s = 1)
]

# MobileNetV3-Large: (k, expanded size, s, ifmap hw)
_V3L: List[Tuple[int, int, int, int]] = [
    (3, 16, 1, 112),
    (3, 64, 2, 112),
    (3, 72, 1, 56),
    (5, 72, 2, 56),
    (5, 120, 1, 28),
    (5, 120, 1, 28),
    (3, 240, 2, 28),
    (3, 200, 1, 14),
    (3, 184, 1, 14),
    (3, 184, 1, 14),
    (3, 480, 1, 14),
    (3, 672, 1, 14),
    (5, 672, 2, 14),
    (5, 960, 1, 7),
    (5, 960, 1, 7),
]
MOBILENET_V3_LARGE: List[DWLayer] = [_dw(e, hw, k, s) for k, e, s, hw in _V3L]

# MobileNetV3-Small
_V3S: List[Tuple[int, int, int, int]] = [
    (3, 16, 2, 112),
    (3, 72, 2, 56),
    (3, 88, 1, 28),
    (5, 96, 2, 28),
    (5, 240, 1, 14),
    (5, 240, 1, 14),
    (5, 120, 1, 14),
    (5, 144, 1, 14),
    (5, 288, 2, 14),
    (5, 576, 1, 7),
    (5, 576, 1, 7),
]
MOBILENET_V3_SMALL: List[DWLayer] = [_dw(e, hw, k, s) for k, e, s, hw in _V3S]

# EfficientNet-B0: MBConv blocks, (k, expanded size, s, ifmap hw)
_EFFB0: List[Tuple[int, int, int, int]] = [
    (3, 32, 1, 112),     # MBConv1
    (3, 96, 2, 112),     # stage 3 first
    (3, 144, 1, 56),
    (5, 144, 2, 56),     # stage 4 first
    (5, 240, 1, 28),
    (3, 240, 2, 28),     # stage 5 first
    (3, 480, 1, 14),
    (3, 480, 1, 14),
    (5, 480, 1, 14),     # stage 6 (s = 1, 14x14)
    (5, 672, 1, 14),
    (5, 672, 1, 14),
    (5, 672, 2, 14),     # stage 7 first
    (5, 1152, 1, 7),
    (5, 1152, 1, 7),
    (5, 1152, 1, 7),
    (3, 1152, 1, 7),     # stage 8
]
EFFICIENTNET_B0: List[DWLayer] = [_dw(e, hw, k, s) for k, e, s, hw in _EFFB0]


# MobileNetV2 pointwise-projection output channels per DW entry above
# (the linear-bottleneck channel the 1x1 conv maps the expanded tensor to;
# arXiv:1801.04381 Table 2).  Drives the fused separable-block traffic
# accounting: the DW table alone cannot price the fused DW+PW pipeline.
MOBILENET_V2_PW_OUT: List[int] = [
    16,                # 32 -> 16, t = 1
    24, 24,            # 96/144 -> 24
    32, 32, 32,        # 144/192 -> 32
    64, 64, 64, 64,    # 192/384 -> 64
    96, 96, 96,        # 384/576 -> 96
    160, 160, 160,     # 576/960 -> 160
    320,               # 960 -> 320
]
assert len(MOBILENET_V2_PW_OUT) == len(MOBILENET_V2)

# (DW stage, pointwise C_out) pairs — the full separable block per layer.
MOBILENET_V2_SEPARABLE: List[Tuple[DWLayer, int]] = list(
    zip(MOBILENET_V2, MOBILENET_V2_PW_OUT))


# EfficientNet-B0 full MBConv blocks: (c_in, c_out, expand_ratio, k, s,
# ifmap hw) per block [arXiv:1905.11946, Table 1; SE ratio 0.25 throughout].
# The DW stage of each entry (c_in * expand_ratio channels at hw) must
# reproduce the EFFICIENTNET_B0 DW table above — asserted below, and the
# model builder in ``models.mbconv`` derives the same list from the stage
# table (tests pin all three views together).
EFFICIENTNET_B0_MBCONV: List[Tuple[int, int, int, int, int, int]] = [
    (32, 16, 1, 3, 1, 112),      # MBConv1
    (16, 24, 6, 3, 2, 112),      # stage 3 first
    (24, 24, 6, 3, 1, 56),
    (24, 40, 6, 5, 2, 56),       # stage 4 first
    (40, 40, 6, 5, 1, 28),
    (40, 80, 6, 3, 2, 28),       # stage 5 first
    (80, 80, 6, 3, 1, 14),
    (80, 80, 6, 3, 1, 14),
    (80, 112, 6, 5, 1, 14),      # stage 6 (s = 1, 14x14)
    (112, 112, 6, 5, 1, 14),
    (112, 112, 6, 5, 1, 14),
    (112, 192, 6, 5, 2, 14),     # stage 7 first
    (192, 192, 6, 5, 1, 7),
    (192, 192, 6, 5, 1, 7),
    (192, 192, 6, 5, 1, 7),
    (192, 320, 6, 3, 1, 7),      # stage 8
]
assert [(k, ci * e, s, hw) for ci, _co, e, k, s, hw
        in EFFICIENTNET_B0_MBCONV] == _EFFB0


# MobileNet-V3 per-row block metadata: (c_in, c_out, SE, act) aligned
# with the DW tables above [arXiv:1905.02244, Tables 1-2].  The DW table
# alone prices only the depthwise stage; the full two-pass fused block
# additionally needs the projection width and the per-row SE/act facts
# (V3 runs relu early stages, hard_swish late, SE on SOME blocks — a
# no-SE row must be priced with zero SE bytes).
MOBILENET_V3_LARGE_META: List[Tuple[int, int, bool, str]] = [
    (16, 16, False, "relu"),
    (16, 24, False, "relu"),
    (24, 24, False, "relu"),
    (24, 40, True, "relu"),
    (40, 40, True, "relu"),
    (40, 40, True, "relu"),
    (40, 80, False, "hard_swish"),
    (80, 80, False, "hard_swish"),
    (80, 80, False, "hard_swish"),
    (80, 80, False, "hard_swish"),
    (80, 112, True, "hard_swish"),
    (112, 112, True, "hard_swish"),
    (112, 160, True, "hard_swish"),
    (160, 160, True, "hard_swish"),
    (160, 160, True, "hard_swish"),
]
assert len(MOBILENET_V3_LARGE_META) == len(MOBILENET_V3_LARGE)

MOBILENET_V3_SMALL_META: List[Tuple[int, int, bool, str]] = [
    (16, 16, True, "relu"),
    (16, 24, False, "relu"),
    (24, 24, False, "relu"),
    (24, 40, True, "hard_swish"),
    (40, 40, True, "hard_swish"),
    (40, 40, True, "hard_swish"),
    (40, 48, True, "hard_swish"),
    (48, 48, True, "hard_swish"),
    (48, 96, True, "hard_swish"),
    (96, 96, True, "hard_swish"),
    (96, 96, True, "hard_swish"),
]
assert len(MOBILENET_V3_SMALL_META) == len(MOBILENET_V3_SMALL)


def mobilenet_v3_chain_rows(variant: str = "large", se_ratio: float = 0.25
                            ) -> tuple:
    """Family-generic ``core.autotune.BlockRow`` chain of MobileNet-V3
    built from the canonical workload tables: each row carries its DW
    stage (expanded width, hw, k, s) plus the per-row projection width, SE
    flag and act from the META tables above."""
    dw_rows, meta = {
        "large": (MOBILENET_V3_LARGE, MOBILENET_V3_LARGE_META),
        "small": (MOBILENET_V3_SMALL, MOBILENET_V3_SMALL_META),
    }[variant]
    from .autotune import BlockRow
    return tuple(
        BlockRow(dw.h, dw.w, c_in, dw.c, c_out, dw.k, dw.s,
                 family="mbconv", act=act,
                 se_ratio=se_ratio if se else 0.0)
        for dw, (c_in, c_out, se, act) in zip(dw_rows, meta))


# EfficientNet-V2-S body stages [arXiv:2104.00298, Table 2]:
# (family, expand_ratio, k, s, c_out, repeats) — Fused-MBConv stages 1-3
# (dense expand+DW collapse, no SE), MBConv tail with SE 0.25; the
# table ``models.mbconv`` builds V2-S from.
EFFICIENTNET_V2_S_STAGES: List[Tuple[str, int, int, int, int, int]] = [
    ("fusedmb", 1, 3, 1, 24, 2),
    ("fusedmb", 4, 3, 2, 48, 4),
    ("fusedmb", 4, 3, 2, 64, 4),
    ("mbconv", 4, 3, 2, 128, 6),
    ("mbconv", 6, 3, 1, 160, 9),
    ("mbconv", 6, 3, 2, 256, 15),
]


def effnet_v2_chain_rows(h: int = 112, w: int = 112,
                         se_ratio: float = 0.25, stem_c: int = 24
                         ) -> tuple:
    """The EfficientNet-V2-S ``BlockRow`` chain (40 blocks) at
    stem-output spatial dims ``h`` x ``w`` — a MIXED-FAMILY chain: the
    fused head's rows carry ``family="fusedmb"`` (one pass, no SE), the
    tail ``family="mbconv"`` with SE.
    The expansion-1 fused stage widens c_mid to c_out so the single-pass
    projection stays well-formed (matching the model builder)."""
    from .autotune import BlockRow
    rows, c_in, hh, ww = [], stem_c, h, w
    for family, expand, k, s, c_out, repeats in EFFICIENTNET_V2_S_STAGES:
        for i in range(repeats):
            si = s if i == 0 else 1
            c_mid = max(c_in * expand, c_out) if family == "fusedmb" \
                else c_in * expand
            rows.append(BlockRow(
                hh, ww, c_in, c_mid, c_out, k, si, family=family,
                act="silu",
                se_ratio=0.0 if family == "fusedmb" else se_ratio))
            hh, ww = -(-hh // si), -(-ww // si)
            c_in = c_out
    return tuple(rows)


# EfficientNet-V2-style k=7 stem probes: the fused-MBConv heads of the V2
# family push the DW kernel to 7x7 at stem resolutions.  The HBM traffic
# model is k-generic; these rows pin k=7 in the workload tables so schedule
# solving and the traffic gate exercise it alongside the paper's k in
# {3, 5}.
EFFICIENTNET_V2_K7_STEM: List[DWLayer] = [
    _dw(48, 112, 7, 2),      # stem head, stride-2 downsample
    _dw(96, 56, 7, 1),       # first body stage at 56x56
]

# (DW stage, pointwise C_out) pairs — the full separable block per k=7 row
# (drives the fused separable-block traffic accounting, as the V2 head's
# projection widths).
EFFICIENTNET_V2_K7_SEPARABLE: List[Tuple[DWLayer, int]] = [
    (EFFICIENTNET_V2_K7_STEM[0], 64),
    (EFFICIENTNET_V2_K7_STEM[1], 96),
]


NETWORKS: Dict[str, List[DWLayer]] = {
    "mobilenet_v1": MOBILENET_V1,
    "mobilenet_v2": MOBILENET_V2,
    "mobilenet_v3_large": MOBILENET_V3_LARGE,
    "mobilenet_v3_small": MOBILENET_V3_SMALL,
    "efficientnet_b0": EFFICIENTNET_B0,
}

# Paper-reported bands (Sec. V / VII) used as reproduction gates.
PAPER_BANDS = {
    # Fig. 7(a): WS ConvDK TM utilization per model (percent)
    "utilization": {
        "mobilenet_v1": 86.15,
        "mobilenet_v2": 86.76,
        "mobilenet_v3_large": 84.00,
        "mobilenet_v3_small": 86.97,
        "efficientnet_b0": 85.94,
    },
    # Fig. 7(c): buffer-traffic reduction vs WS baseline, percent (min, max)
    "buffer_traffic_reduction_ws": (77.4, 87.0),
    # Fig. 7(d): total traffic-energy reduction vs baselines, percent
    "energy_reduction_ws": (10.1, 17.9),
    "energy_reduction_is": (12.8, 20.3),
    # buffer-only energy reductions quoted in Sec. V-C
    "buffer_energy_reduction_ws": (78.4, 87.2),
    "buffer_energy_reduction_is": (81.2, 88.3),
    # Fig. 7(e): total latency reduction, percent
    "latency_reduction_ws": (15.6, 27.8),
    "latency_reduction_is": (18.1, 29.3),
    # Fig. 8: buffer-traffic *latency* reduction, percent
    "buffer_latency_reduction_ws": (50.5, 58.7),
    "buffer_latency_reduction_is": (47.1, 55.9),
    # Fig. 8: baseline buffer-latency share of total latency, percent
    "baseline_buffer_latency_share": (13.1, 16.8),
}
