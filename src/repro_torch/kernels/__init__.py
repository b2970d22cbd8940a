"""Kernel wrappers of the port: each launches a hand-written CUDA kernel
for CUDA tensors and runs its plain PyTorch version for CPU tensors."""

from typing import Dict

from . import convdk_fusedmb, convdk_mbconv
from .convdk_fusedmb import convdk_fusedmb_fused
from .convdk_mbconv import convdk_mbconv_fused

__all__ = ["convdk_fusedmb_fused", "convdk_mbconv_fused", "launches",
           "reset_launches"]


def launches() -> Dict[str, int]:
    """Kernel launches per wrapper since the last ``reset_launches``."""
    return {**convdk_mbconv.LAUNCHES, **convdk_fusedmb.LAUNCHES}


def reset_launches() -> None:
    convdk_mbconv.reset_launches()
    convdk_fusedmb.reset_launches()
