"""Batched vision serving over the fused EfficientNet-B0."""

from .vision import VisionEngine, VisionRequest, VisionResult, VisionServeConfig

__all__ = ["VisionEngine", "VisionRequest", "VisionResult",
           "VisionServeConfig"]
