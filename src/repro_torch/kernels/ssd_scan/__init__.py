"""Mamba2 SSD intra-chunk step: CUDA kernel, plain version, dispatch."""
