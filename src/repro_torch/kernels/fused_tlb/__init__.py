"""Fused cross-wave TLB round: CUDA kernel, plain version, dispatch."""
