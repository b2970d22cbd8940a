"""EfficientNet-B0 over the fused MBConv kernels."""
