"""EfficientNet-V2-S classifier configs (``models.mbconv``)."""

from __future__ import annotations

from ..models.mbconv import EFFNET_V2_S_STAGES, EffNetV2Config

__all__ = ["EFFNET_V2_S_STAGES", "EffNetV2Config", "efficientnet_v2_s",
           "efficientnet_v2_s_smoke"]


def efficientnet_v2_s(**overrides) -> EffNetV2Config:
    """The full EfficientNet-V2-S (1000 classes; published eval size
    384x384) config: 10 Fused-MBConv + 30 MBConv blocks."""
    return EffNetV2Config(**overrides)


def efficientnet_v2_s_smoke(**overrides) -> EffNetV2Config:
    """A test-sized V2-S: 1/4 width, a 128-wide head and one stage of each
    kind (expansion-1 fused, strided fused, strided MBConv)."""
    overrides.setdefault("width_mult", 0.25)
    overrides.setdefault("num_classes", 4)
    overrides.setdefault("head_c", 128)
    overrides.setdefault("stages", (("fusedmb", 1, 3, 1, 24, 1),
                                    ("fusedmb", 4, 3, 2, 48, 2),
                                    ("mbconv", 4, 3, 2, 64, 2)))
    return EffNetV2Config(**overrides)
