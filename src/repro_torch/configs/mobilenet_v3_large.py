"""MobileNet-V3-Large classifier configs (``models.mbconv``)."""

from __future__ import annotations

from ..models.mbconv import MOBILENET_V3_LARGE_BLOCKS, MobileNetV3Config

__all__ = ["MOBILENET_V3_LARGE_BLOCKS", "MobileNetV3Config",
           "mobilenet_v3_large", "mobilenet_v3_large_smoke"]


def mobilenet_v3_large(**overrides) -> MobileNetV3Config:
    """The full MobileNet-V3-Large (224x224, 1000 classes) config."""
    return MobileNetV3Config(**overrides)


def mobilenet_v3_large_smoke(**overrides) -> MobileNetV3Config:
    """A test-sized V3-Large: the same 15-block table at 1/8 width."""
    overrides.setdefault("width_mult", 0.125)
    overrides.setdefault("num_classes", 4)
    return MobileNetV3Config(**overrides)
