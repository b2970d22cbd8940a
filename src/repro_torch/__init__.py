"""PyTorch/CUDA port of the ConvDK dataflow (EfficientNet-B0 serving;
EfficientNet-V2-S and MobileNet-V3-Large inference; training of the
MobileNet-style separable net; Mamba-2 2.7B prefill and decode serving).

The JAX package ``repro`` is the reference; this package keeps its module
names so each counterpart is easy to find, and imports nothing of it.  The
Pallas kernels of the MBConv, Fused-MBConv, separable and causal conv1d
paths are hand-written CUDA C++ for Hopper (``kernels/csrc/mbconv.cu``,
``kernels/csrc/fusedmb.cu``, ``kernels/csrc/separable.cu``,
``kernels/csrc/conv1d.cu``), built with ``nvcc`` at first use.
"""

__all__ = ["configs", "core", "examples", "kernels", "launch", "models",
           "serve", "train"]
