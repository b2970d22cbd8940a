"""EfficientNet-B0 classifier configs (``models.mbconv``)."""

from __future__ import annotations

from ..models.mbconv import EFFNET_B0_STAGES, EffNetConfig

__all__ = ["EFFNET_B0_STAGES", "EffNetConfig", "efficientnet_b0",
           "efficientnet_b0_smoke"]


def efficientnet_b0(**overrides) -> EffNetConfig:
    """The canonical EfficientNet-B0 (224x224, 1000 classes) config."""
    return EffNetConfig(**overrides)


def efficientnet_b0_smoke(**overrides) -> EffNetConfig:
    """A test-sized B0: same 16-block topology at 1/4 width."""
    overrides.setdefault("width_mult", 0.25)
    overrides.setdefault("num_classes", 10)
    return EffNetConfig(**overrides)
