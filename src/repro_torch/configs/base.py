"""Architecture registry: full configs, reduced smoke configs, input shapes
and per-cell skip rules of the language-model archs the port runs.

Counterpart of the registry half of ``repro.configs.base`` (``ShapeCell``,
``SHAPES``, ``ArchSpec``, ``register``, ``get_arch``, ``list_archs`` and
the skip rules).  Only the ported archs register: Mamba-2, the dense
decoders, RecurrentGemma and the MoE family (Granite-MoE 3B-A800M and
DeepSeek-V2 with MLA); the encoder and the VLM are ROADMAP A items
12.4.3-12.4.4.  The JAX module's ``ConvKernelConfig`` and ``SchedulePin`` are
not ported: the port's blocks take their pins as arguments.

Shape cells:
  train_4k     seq 4,096   global_batch 256   (train_step)
  prefill_32k  seq 32,768  global_batch 32    (serve prefill)
  decode_32k   seq 32,768  global_batch 128   (serve_step, 1 new token)
  long_500k    seq 524,288 global_batch 1     (serve_step, sub-quadratic only)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..models.model import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    config: ModelConfig
    smoke: ModelConfig
    skips: Dict[str, str]  # shape name -> reason

    def applicable(self, shape: str) -> bool:
        return shape not in self.skips

    def cells(self) -> List[Tuple[str, Optional[str]]]:
        return [(s, None if self.applicable(s) else self.skips[s])
                for s in SHAPES]


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"arch {spec.arch_id!r} registered twice")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    """The spec of ``arch_id``; KeyError for an arch the port does not
    register."""
    _ensure_loaded()
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


SKIP_LONG = {"long_500k": "full quadratic attention; 524k decode requires "
                          "sub-quadratic sequence mixing"}
SKIP_ENC = {"decode_32k": "encoder-only: no autoregressive decode step",
            "long_500k": "encoder-only: no autoregressive decode step"}


def _ensure_loaded() -> None:
    # import the per-arch modules once (they register themselves)
    from . import (  # noqa: F401
        deepseek_v2_236b, gemma_2b, granite_moe_3b_a800m, mamba2_2p7b,
        mistral_large_123b, phi3_mini_3p8b, qwen1p5_4b, recurrentgemma_9b,
    )
