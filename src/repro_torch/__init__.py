"""PyTorch/CUDA port of the ConvDK MBConv dataflow (EfficientNet-B0
serving; EfficientNet-V2-S and MobileNet-V3-Large inference).

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing of it.  The
Pallas kernels of the MBConv and Fused-MBConv paths are hand-written CUDA
C++ for Hopper (``kernels/csrc/mbconv.cu``, ``kernels/csrc/fusedmb.cu``),
built with ``nvcc`` at first use.
"""

__all__ = ["configs", "core", "kernels", "models", "serve"]
