"""Kernel wrappers of the port: each launches a hand-written CUDA kernel
for CUDA tensors and runs its plain PyTorch version for CPU tensors."""

from typing import Dict

from . import (convdk_conv1d, convdk_dw, convdk_fused, convdk_fusedmb,
               convdk_mbconv)
from .convdk_fused import convdk_fused_separable
from .convdk_fusedmb import convdk_fusedmb_fused, convdk_fusedmb_staged
from .convdk_mbconv import convdk_mbconv_fused, convdk_mbconv_staged
from .ops import (
    convdk_causal_conv1d,
    convdk_depthwise2d,
    convdk_separable_staged,
    stage_row_strips,
    stage_seq_strips,
)

_MODULES = (convdk_mbconv, convdk_fusedmb, convdk_fused, convdk_dw,
            convdk_conv1d)

__all__ = ["convdk_causal_conv1d", "convdk_depthwise2d",
           "convdk_fused_separable", "convdk_fusedmb_fused",
           "convdk_fusedmb_staged", "convdk_mbconv_fused",
           "convdk_mbconv_staged",
           "convdk_separable_staged", "launches", "reset_launches",
           "stage_row_strips", "stage_seq_strips"]


def launches() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launches``."""
    return {k: v for m in _MODULES for k, v in m.LAUNCHES.items()}


def reset_launches() -> None:
    for m in _MODULES:
        m.reset_launches()
