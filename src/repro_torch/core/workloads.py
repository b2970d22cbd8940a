"""MobileNet-V2's depthwise-separable blocks at their published widths.

A copy of ``MOBILENET_V2``, ``MOBILENET_V2_PW_OUT`` and
``MOBILENET_V2_SEPARABLE`` from ``repro.core.workloads`` (arXiv:1801.04381,
Table 2, the canonical 224x224 input): each block's depthwise stage (the
channels of the expanded tensor it runs on, the ifmap side there, kernel,
stride) and the channels its pointwise projection maps them to.  These 17
blocks are the repo's full-width separable shapes: the fused separable
kernel is checked and timed on them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple


@dataclass(frozen=True)
class DWLayer:
    """One depthwise-conv layer: C channels, HxW ifmap, k x k kernel,
    stride s, SAME padding."""

    c: int
    h: int
    w: int
    k: int
    s: int


def _dw(c: int, hw: int, k: int, s: int) -> DWLayer:
    return DWLayer(c=c, h=hw, w=hw, k=k, s=s)


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

# the pointwise-projection output channels per DW entry above
MOBILENET_V2_PW_OUT: List[int] = [
    16,                # 32 -> 16, t = 1
    24, 24,            # 96/144 -> 24
    32, 32, 32,        # 144/192 -> 32
    64, 64, 64, 64,    # 192/384 -> 64
    96, 96, 96,        # 384/576 -> 96
    160, 160, 160,     # 576/960 -> 160
    320,               # 960 -> 320
]

# (DW stage, pointwise C_out) pairs: the full separable block per layer.
MOBILENET_V2_SEPARABLE: List[Tuple[DWLayer, int]] = list(
    zip(MOBILENET_V2, MOBILENET_V2_PW_OUT, strict=True))
