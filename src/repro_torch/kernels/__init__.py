"""Kernel wrappers of the port: each launches a hand-written CUDA kernel
for CUDA tensors and runs its plain PyTorch version for CPU tensors."""

from .convdk_mbconv import LAUNCHES, convdk_mbconv_fused, reset_launches

__all__ = ["LAUNCHES", "convdk_mbconv_fused", "reset_launches"]
