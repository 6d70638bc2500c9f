"""Flash attention: CUDA kernel, plain version, dispatch."""
