"""PyTorch/CUDA port of the ConvDK dataflow (EfficientNet-B0 serving;
EfficientNet-V2-S and MobileNet-V3-Large inference; training of the
MobileNet-style separable net).

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing of it.  The
Pallas kernels of the MBConv, Fused-MBConv and separable paths are
hand-written CUDA C++ for Hopper (``kernels/csrc/mbconv.cu``,
``kernels/csrc/fusedmb.cu``, ``kernels/csrc/separable.cu``), built with
``nvcc`` at first use.
"""

__all__ = ["configs", "core", "examples", "kernels", "models", "serve"]
