"""PyTorch port of the MASK reproduction, written for one NVIDIA H100.

`repro_torch` mirrors `repro`'s module paths and public names: the
simulator's main path (`sim.runner.run_mix` scanning `sim.memsys.step`
once per simulated cycle) and the policy mechanisms it draws on
(`core.*`); the dense model's serving path (`models.model`:
`forward_prefill`, `forward_decode`, `forward_train`) with its configs
(`configs`); the multi-tenant serving stack (`serving`: the engine, its
placement policies and the simulator-backed contention oracle;
`launch.serve`). The fused probe+fill round of the shared caches and the
model's full-sequence attention run in hand-written CUDA kernels
(`kernels/fused_tlb`, `kernels/flash_attention`; sources in `csrc/`).

The package imports `torch` and `numpy` only. Its entry points run on the
card unless the caller names another device (`device="cpu"`); see
`repro_torch.device`.
"""
