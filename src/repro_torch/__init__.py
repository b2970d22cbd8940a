"""PyTorch/CUDA port of the ConvDK MBConv dataflow (EfficientNet-B0 serving).

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing of it.  The
three Pallas kernels of the MBConv path are hand-written CUDA C++ for
Hopper (``kernels/csrc/mbconv.cu``), built with ``nvcc`` at first use.
"""

__all__ = ["configs", "core", "kernels", "models", "serve"]
