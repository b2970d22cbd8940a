"""Batched serving: vision over the fused EfficientNet-B0, and the LM
engine (prefill + decode, BIG/LITTLE admission)."""

from .engine import Engine, ServeConfig
from .vision import VisionEngine, VisionRequest, VisionResult, VisionServeConfig

__all__ = ["Engine", "ServeConfig", "VisionEngine", "VisionRequest",
           "VisionResult", "VisionServeConfig"]
