"""PyTorch port of the MASK reproduction, written for one NVIDIA H100.

`repro_torch` mirrors `repro`'s module paths and public names: the
simulator's main path (`sim.runner.run_mix` scanning `sim.memsys.step`
once per simulated cycle) and the policy mechanisms it draws on
(`core.*`). The fused probe+fill round of the shared caches runs in a
hand-written CUDA kernel (`kernels/fused_tlb`, source `csrc/fused_tlb.cu`).

The package imports `torch` and `numpy` only. Its entry points run on the
card unless the caller names another device (`device="cpu"`); see
`repro_torch.device`.
"""
