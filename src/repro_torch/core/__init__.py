"""Core packing and quantization algebra (no kernels)."""
