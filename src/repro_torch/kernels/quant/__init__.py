"""Low-bit Module kernels: fused quantize+bitpack and unpack+dequantize."""
