#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

  1. build  -- compile `src/repro_torch/csrc/fused_tlb.cu`,
               `flash_attention_sm90.cu`, `flash_attention.cu`,
               `ssd_scan.cu` and `paged_attention.cu` for sm_90a, one nvcc
               each, in parallel;
  2. kernel -- the `fused_tlb` kernel against its plain PyTorch version on
               the card, element for element (exact: integer outputs), at
               both main-path shapes, the reference kernel test's shapes
               and the write-collision case; at both main-path shapes the
               kernel's device time (CUDA-graph replay) beside the floor
               of one launch measured the same way (a captured `x.add_(1)`
               on a one-element tensor), its time per launch from Python,
               and the plain version's time;
  3. path   -- the simulator's main path, `run_mix(..., device="cuda")`,
               on all 9 float-hex goldens of the reference; the kernel's
               launch count must equal the fused rounds the runs made;
               run_mix == run_pair and idle partner == run_solo;
  4. timed  -- simulated cycles per second of the 9000-cycle mask run
               (the `mask@9000` golden of phase 3);
 12. grid   -- (run right after phase 4, on its build) the simulator's
               grid layer: the row-axis `fused_tlb` (one block per row,
               all rows in one launch) against its plain version, exactly,
               at R = 1, 3 and 16 rows of seeded inputs at both main-path
               shapes, and each row against the kernel run on that row
               alone; at R = 21 with rows whose lanes are all masked off
               (7 at the L2$ shape; 18 at the PWC shape, as in the mixed
               group's PWC round), which must come back unchanged, with
               no hit or fill; its device time at R = 1 and 40 (graph replay,
               beside the launch floor); `run_grid` over the 8 designs x
               3 mixes at 1200 cycles as 2 passes (`ideal`'s 3 rows; the
               other 7 designs' 21 rows, each knob per row), whose 3DS+BLK
               cells must give the 8 1200-cycle goldens float-hex, with
               `fused_tlb` launches == the passes' rounds, 3600 (1200 +
               1200 x 2: the group's PWC round masks its non-pwc rows),
               not rounds x rows; grid == `run_mix` bitwise for
               ideal/pwc/mask x 2 solo mixes at 300 cycles (pwc and mask
               as one pass); `sweep` == the per-design `Experiment` loop
               (raw stats and derived metrics); `predict_mixes` with
               `pad_rows` twice sets up 1 plan, then 0
               (`runner.TRACE_COUNT`); no host sync in a step at R = 8
               and in a mixed step of 7 designs x 3 mixes (R = 21)
               (`set_sync_debug_mode("error")`); phase 4's one-design mask
               step issues the operations it issued before per-row knobs
               (`PARENT_MASK_STEP_OPS`, counted at the dispatcher); the
               wall time of 8 designs x 5 pairs x 300 cycles grouped (2
               passes) against one `run_grid` per design (8 passes), in
               turns (grouped, per design, per design, grouped), the
               cells equal bitwise; then simulated row-cycles per second
               of one mask pass of 300 cycles at R = 1, 8 and 40 (the 20
               pairs of `pair_workloads(n_pairs=20)` and 20 of their
               solos), and at R = 40 a `torch.profiler` window's device
               time, kernels and device busy share per step;
 13. churn  -- (run right after phase 12, on its build) the churn runner,
               `fused_tlb` in every cycle of every segment: `run_trace(
               "mask", [("3DS", "BLK")] * 4, seg_cycles=300)` gives the
               1200-cycle mask golden float-hex with launches == rounds;
               a seeded trace (`churn_schedule(seed=3, n_segments=8,
               n_slots=4)`, 250 cycles a segment, a fault plan with every
               kind and flush level, `audit=True`) equals the same trace
               through the CPU path (the plain round) in every snapshot
               and its final state, bit for bit, with launches == its
               2000 rounds and the final `asid_of_app` == slot + 4 x the
               slot's changes; a 3-segment `pwc` trace (a full PWC flush
               at each boundary) equals its CPU run with 2 launches a
               cycle; one boundary at full width runs with no host sync
               (`set_sync_debug_mode("error")`); the trace's simulated
               cycles per second and a boundary's device ms (20 in a
               `torch.profiler` window);
  5. flash  -- the `flash_attention` kernels against their plain PyTorch
               version on the card, each check on the route its dtype
               selects (bf16: the wgmma kernel `flash_attention_sm90.cu`;
               fp32: the split-TF32 kernel `flash_attention.cu`; the route
               counts are checked): the reference kernel test's 18
               cases (atol = rtol = 2e-2 in
               bf16, 2e-5 in fp32), phase 7's ragged 496-token prefill
               shape, 11 edge cases on both routes (`FLASH_EDGES`: S =
               1000, 129, 77 and 1, windows across the tensor-core
               kernel's 128-row tiles, non-causal, G of 1, 4 and 8, dh 32,
               64, 96 and 128), and the serving shape, qwen3-4b prefill (B=4,
               S=2048, 32 heads, 8 KV heads, dh 128, causal, bf16, in the
               model's strided layout), the bf16 checks past the sweep
               held to the rounding bound of `flash_compare`; at the
               serving shape the tensor-core kernel's device time (CUDA
               events), TFLOP/s and share of its bound, its time per
               launch from Python, the plain version's time, and
               `scaled_dot_product_attention`'s time as a yardstick; the
               same times of the split-TF32 kernel at phase 7's fp32 shape
               (SDPA in fp32), with two bounds side by side: its
               tensor-core products' (3 TF32 passes) and the CUDA cores'
               fp32 bound of the SIMT kernel it replaced; the fp32
               checks' largest share of 2e-5;
  6. serve  -- the model's serving path at full width: qwen3-4b (36
               layers) in bf16 with random weights from a seeded generator
               on the card, `attention_impl="pallas_flash"`; 4 prompts of
               2048 tokens through `forward_prefill` (max_len 2112), twice
               (cold, then timed), then 64 greedy `forward_decode` steps;
               flash launches == 36 per prefill, finite logits, cache_len
               2112 at the end; every flash launch on the wgmma route;
  7. match  -- the same model in fp32 (TF32 off for matmul and cuDNN):
               `forward_prefill` of 2 x 496 tokens (its wall time logged)
               plus 16 `forward_decode` steps against `forward_train`
               over the same 512 tokens (logits within 2e-3 after
               prefill, 5e-3 in decode); the 72 flash launches (36 in
               each) all on the split_tf32 route;
  8. ssd    -- the `ssd_scan` kernel (`ssd_intra_chunk`) against its plain
               version on the card: the reference test's 3 cases, a
               ragged chunk of 248 rows and 4 edge cases of the kernel
               (`SSD_EDGES`: chunks of 520, 300 and 1040 rows, 2, 3 and 10
               heads, hd 18 / ds 10) at atol = rtol = 1e-4, with `ops.ssd_scan`
               against the O(S) recurrence on the same inputs; the
               serving shape (mamba2-1.3b prefill, B=4, S=2048, 64 heads
               of 64, d_state 128, chunks of 256) held to a limit from
               each output's sum of |terms| with the split-TF32 term
               (`ssd_scan.ref.ssd_limits`, `ssd_compare`), checked to reject a wrong
               head or q tile; there the kernel's device time, its time
               per launch from Python, the plain version's time, the
               bound of its tensor-core products and the fp32 CUDA-core
               bound of the kernel it replaced;
  9. mamba2 -- mamba2-1.3b at full width and depth (48 layers) in bf16
               with random weights from a seeded generator on the card: 4
               prompts of 2048 tokens through `forward_prefill`, twice
               (cold, then timed), then 64 greedy `forward_decode` steps;
               ssd launches == 48 per prefill, finite logits;
 10. m-match -- the same model in fp32, TF32 off: `forward_prefill` of 2 x
               496 tokens (chunks of 248 rows) plus 16 `forward_decode`
               steps against `forward_train` over the same 512 tokens
               (chunks of 256), within 2e-3 after prefill, 5e-3 in decode;
 11. paged  -- the `paged_attention` kernel (split + combine, two CUDA
               launches per call) against its plain version on the
               reference test's 3 cases, `PAGED_EDGES` (G = 16 and 12 at
               dh 128, dh 96) and `PAGED_SPLIT_EDGES` (the CPU test's
               split cases and lengths 1, 128, 129, 8192 over 64 pages),
               in both dtypes (atol = rtol = 2e-5 fp32, 3e-2 bf16); then
               a paged KV pool at qwen3-4b's serving
               widths built through `repro_torch.memmgr` (36 layers, 520
               pages of 128 tokens, 8 KV heads of 128, bf16; 32 sequences
               under 4 ASIDs, seeded prompt lengths up to 2040 with 128,
               1024 and 1920 among them), the prompts' K/V written by this
               script through the block table, then 8 decode steps of
               `append_token_alloc` and, per layer, `write_kv` and
               `paged_attention` on `gather_block_table`'s table: every
               launch held to the plain version, the plain version at the
               last step held to dense attention over this script's own
               contiguous copy of the tokens (bf16 rounding limit of
               `flash_compare`), launches == 36 x 8; the split plan
               logged, two runs equal bit for bit; one layer's call
               timed against its bound.

 14. serve-stack -- (run after phase 11, on its builds) the serving stack,
               `repro_torch.serving` and `launch/serve.py`: (a) the
               reference's overload record: `benchmarks/serving_bench.py`'s
               `overload_run(seed=0)` settings copied here (flood_vs_trickle,
               240 steps, the 64-page pool, `overload_plan(0)`, stub
               forwards, max_batch 8 / max_running 12, the oracle at 300
               cycles, 2 slots, pad_rows 8, epoch 8, degrade 0.4 /
               re-engage 0.28 over 2 epochs, `Recalibrator(alpha=0.5)`,
               solo hints from the `none` policy) must give
               `BENCH_serving.json`'s `overload` section exactly, in two
               builds, with `fused_tlb` launches == the oracle's grid passes
               x 300; (b) qwen3-4b at full width (bf16, seeded random
               weights, `pallas_flash`) served by `ServingEngine` under the
               oracle policy (300 cycles) over flood_vs_trickle(seed=0,
               steps=32), the pool at the model's KV widths (16 sequences x
               8 pages of 128): 0 lost or duplicated, flash launches == 36 x
               the prefills the engine ran (all wgmma), `fused_tlb` == grid
               passes x 300, every logit finite, the first finished
               request's tokens == a direct greedy prefill + decode bit for
               bit; engine steps/s, decoded tokens/s, the oracle's share of
               wall time, peak memory; (c) `python -m
               repro_torch.launch.serve --arch qwen3-4b --trace
               flood_vs_trickle --steps 24 --policy oracle --faults
               --fault-rate 0.1` in a process of its own exits 0 with
               `lost 0 duplicated 0`; (d) full-width olmoe-1b-7b (bf16,
               seeded random weights, `pallas_flash`) served by
               `ServingEngine` under the `none` policy over
               flood_vs_trickle(seed=0, steps=16), the pool at its KV
               widths: 0 lost or duplicated, flash launches == 16 x the
               prefills (all wgmma), every logit finite, the first
               finished request == a direct greedy run bit for bit, the
               kernel == its plain version at the engine's prefill
               shapes; (e) `python -m repro_torch.launch.serve --arch
               olmoe-1b-7b` and `--arch whisper-base` (the reduced
               models), each in a process of its own, exit 0 with `lost 0
               duplicated 0`.
 15. moe    -- olmoe-1b-7b at full width and depth (16 layers, d_model
               2048, 64 experts of 1024, top-8; 6.92 B params, bf16,
               seeded random weights, `pallas_flash`): 4 prompts of 2048
               tokens through `forward_prefill`, twice (cold, then timed
               with CUDA events around each `moe_apply`: the MoE FFNs'
               share of the prefill's device time), flash launches == 16
               per prefill, all wgmma; 64 greedy `forward_decode` steps at
               B = 4 (the batch routes as one group), finite logits; two
               runs of one MoE layer at (4, 2048) bit-equal; the kernel ==
               its plain version at the prefill's shape; then the same
               widths at 2 layers in fp32 (TF32 off, capacity_factor =
               64 so no token is dropped: dropped_frac == 0 in every call)
               as phase 7: prefill of 2 x 496 + 16 decode steps against
               `forward_train` within 2e-3 / 5e-3, 4 flash launches on
               the split_tf32 route;
 16. families -- each at full width, freed before the next, bf16, seeded
               random weights, one prefill and greedy decode steps, the
               flash launches per prefill counted (all wgmma) and the
               kernel held to its plain version at the prefill's shape:
               phi-3-vision-4.2b (32 layers; 64 seeded patch embeddings
               ahead of 1984 tokens x 4, dh 96, 16 decode steps, 32
               launches); whisper-base (6 + 6 layers; 1500 seeded frames,
               4 prompts of 448 tokens, 64 decode steps, 6 launches: its
               encoder and cross attention are naive, as the
               reference's); mixtral-8x22b cut to 2 layers (5.41 B
               params): one prompt of 5120 tokens, past its window of
               4096, 8 decode steps, 2 launches, and its fp32 match
               (capacity_factor 8, no drop) within the window as phase 7;
               jamba-1.5-large-398b cut to one period of 8 layers at
               d_model 2048 (16 heads, 2 KV heads of 128, d_ff 6144; 16
               experts, top-2, MoE every 2nd layer, attention every 8th,
               d_state 128, SSM heads of 64 kept; 3.03 B params: one
               period at d_model 8192 is ~40 B params and does not fit
               one card): 4 x 2048, 16 decode steps, flash 1 and ssd 7
               launches per prefill (its SSD shape is phase 8's serving
               shape); int8: qwen3-4b at full width and olmoe at 2 layers
               with `quantize_weights` (the blocks by `quantize_arrays`,
               dequantized per block): a decode step after a 4 x 512
               prefill against bf16's under the reference's law, max |d|
               / std(bf16 logits) < 0.1, and the step's time in both.
 17. train  -- the training path (`repro_torch.train`, `launch/train.py`):
               (a) `ssd_scan.ops.ssd_intra_chunk` on the card runs the
               kernel inside its autograd Function (one launch, the
               Function's grad_fn on every output); its gradients of x,
               dA, B and C at phase 8's serving shape == autograd through
               the plain version within 1e-5 x each one's max |g|, and
               forward + backward timed both ways; (b) reduced fp32
               qwen3-4b, mamba2-1.3b and olmoe-1b-7b (capacity_factor =
               n_experts), 4 x 64 seeded tokens and labels, remat on: one
               `build_loss_fn` gradient on the card against the port on
               the CPU from the same params, loss within 1e-5 (relative)
               and every grad leaf within 1e-4 of its max |g| (TF32 off),
               ssd launches == 2 x layers (forward + recompute); with
               `pallas_flash` the gradient raises NotImplementedError, as
               the reference; (c) full-width mamba2-1.3b (48 layers,
               d_model 2048, vocab 50280; bf16 params, AdamW with fp32
               moments, remat): 3 `train_step`s of 16 x 4096 seeded random
               tokens and labels (train_4k's length; its batch of 256 cut
               to 16 for one card) in 8 microbatches of 2: losses and
               grad norms finite, params finite, ssd launches == (48
               forward + 40 to rebuild the block boundaries of each group
               of `_scan_group(48)` = 6 but its last + 48 per-block
               recomputes) x 8 x 3; seconds per step, tokens/s, peak
               memory; (d) `python -m repro_torch.launch.train --arch
               qwen3-4b --smoke` in one process with deterministic
               algorithms (CUBLAS_WORKSPACE_CONFIG=:4096:8): 10 steps, a
               resume to 14 and an unbroken 14 whose step-14 checkpoints
               are bit-equal, and 30 steps whose loss falls by more than
               0.1.
 18. distributed -- the distributed layer (`distributed/sharding.py`,
               `launch/mesh.py`, `roofline/`, `run_grid(devices=N)`):
               (a) `runner._shard_devices` patched to 4 x cuda:0: `sweep`
               of mask and gpu-mmu x (3DS, BLK), (MUM, RED), (3DS, MUM) at
               120 cycles with solo baselines, sharded over the 4 (the
               group's 14 rows padded to 16, shards of 4) == the same
               sweep unsharded, every stat float-hex, fused_tlb launches
               == shards x 120 rounds; unpatched, `run_grid(devices=2)`
               on one card raises ValueError naming devices=2; (b)
               full-width mamba2-1.3b (bf16, 48 layers, train_4k's 4096
               tokens), one microbatch of 2 x 4096, AdamW, fsdp: the plain
               `build_train_step` (results kept on the host), then the
               same step from the same seed with DTensor params and
               moments on a (1, 1) `DeviceMesh` over a one-rank NCCL
               group (`make_host_mesh`, `Sharder.param_sharding`) and
               `Sharder.constrain`: loss and every updated param
               bit-equal, ssd launches == 136 in each (as phase 17 (c)
               per microbatch), the SSD kernel on each rank's local shard;
               (c) qwen3-4b bf16 `forward_prefill` of 4 x 2048 with the
               (1, 1) mesh's DTensor params and `constrain`: logits
               bit-equal to phase 6's, 36 flash launches on the wgmma
               route; (d) the step's FLOPs from `roofline.counter` beside
               `roofline.analysis.model_flops` (printed, no limit).
 19. dryrun -- `launch/dryrun.py` on a 512-rank "fake" process group
               (started after phase 18's group is gone, and ended):
               (a) `lower_cell("mamba2-1.3b", "prefill_32k")` at full
               width (48 layers, 32 x 32768 tokens, 2 sequences a rank on
               the (16, 16) mesh's data axis) on the CUDA route: the
               ssd kernel's fake branch 48 times, no launch; the report's
               memory, FLOPs, HBM, collective keys and the roofline's
               dominant term printed; (b) the same cell on the CPU route
               (the plain SSD): argument, output and alias bytes and the
               collective bytes by op equal (a)'s; both routes' counted
               FLOPs and their ratio printed; (c) the counter's peak of
               live bytes over qwen3-4b's 4 x 2048 bf16 prefill traced
               under `FakeTensorMode` within 15% of the allocator's rise
               (`max_memory_allocated` above the bytes allocated before)
               over the same call run for real; (d) `python -m
               repro_torch.launch.dryrun --arch qwen3-4b --shape
               decode_32k --multi-pod both` in a subprocess: exit 0, two
               reports, both ok; and `--shape long_500k` prints the
               reference's skip line.
 20. contracts -- every input the reference's Pallas kernels take that
               the card once refused, each on its hand-written kernel
               against the plain version, within the limits above:
               flash at dh 80, 100, 192 and 256 and H = 8 over KV = 1, in
               both dtypes, and a q off 16 bytes and a k whose rows are
               off 16 bytes (staged);
               paged at G = 32 and 71, dh 80, 100 and 256, in both
               dtypes, and a q off 16-byte alignment and a non-contiguous
               one (staged); ssd at hd 128 / ds 256, hd 100 / ds 200, hd
               256 / ds 256 over a chunk of 1040 rows (the windows), and a
               non-contiguous x (staged); `fused_tlb` at 1056 lanes (132
               cores) and 2048, on (3, 5) planes at R = 2 and on 16-way
               planes off 16 bytes, bit-equal. Launches counted by route
               and staged calls counted; dh 264, float16 and a chunk past
               30656 rows raise ValueError with no launch. Timed, each
               beside its bound (the wrapper's `work()` formulas) and the
               plain version: flash at dh 256 (B 4, S 2048, 16 heads over
               8 KV heads, causal) in both dtypes beside
               `scaled_dot_product_attention`; paged at G 32 and 71; ssd
               at hd 128, ds 256; `fused_tlb` at 1056 lanes. Phases 2-19
               must count 0 staged calls.
 21. replay -- the cycle step replayed as CUDA graphs (`sim/replay.py`,
               every `runner.simulate` on the card) against a plain eager
               loop of `memsys.eager_step`, bit for bit in every state
               leaf: (a) grid2's stacked pass (7 designs x 325 rows,
               every knob per row, 200 cycles); (b) `mask` over every
               3-app bundle and solo row (2,325 rows); (c) `mask` and
               `gpu-mmu` stacked with the epoch cut to 40 over 130 cycles
               (three eager epoch cycles); (d) `run_trace` with a churn
               schedule, a random fault plan and the audit, every
               snapshot float-hex, one `fused_tlb` launch a cycle; (e)
               one 60-row pass, the shape of `sweep2-paper35`. Each logs
               the host ms a pass-cycle, the Python launches (runtime
               launch calls) and device ms a cycle, graphed and eager, and
               the key's memory pool and buffer bytes.
 22. mla flash -- `flash_attention_bhsd` with q/k and v of two widths
               and a given scale (latent attention: 192 / 128, the
               softmax scale 0.114721): the instance <192, 128> and the
               staged pairs against the plain version within the rounding
               bound; at the prefill cell's shapes (1 x 32768, 2 x 16384,
               16 heads, causal) the time, the bound by operations, the
               last 256 rows against the plain arithmetic, and
               `scaled_dot_product_attention`'s time and output beside it.

The line before the last is the card's name and power limit; the last
line is `{"ok": true, "device": {...}}`. Needs one CUDA device; exits
non-zero without one, and outside a checkout of the repository.
"""
import collections
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# the reference's pins (tests/test_memsys_stages.py GOLDEN), copied: this
# script imports nothing of the JAX package or its tests
GOLDEN = {
    'ideal': {
        'ipc': ['0x1.490aaaaaaaaabp+7', '0x1.5b4e81b4e81b5p+5'],
        'l2_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'walk_lat': ['0x0.0p+0', '0x0.0p+0'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x0.0p+0'],
    },
    'pwc': {
        'ipc': ['0x1.4e80000000000p+6', '0x1.bbd0369d0369dp+3'],
        'l2_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'walk_lat': ['0x1.5026f7e1b0fb2p+7', '0x1.5aaa0a82a0a83p+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.cb5d4ef40991fp-7'],
    },
    'gpu-mmu': {
        'ipc': ['0x1.642aaaaaaaaabp+6', '0x1.0951eb851eb85p+4'],
        'l2_hit_rate': ['0x1.54629b7f0d463p-2', '0x1.ce36b4175b466p-3'],
        'walk_lat': ['0x1.9d6e4630d013fp+7', '0x1.52af50af50af5p+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.c94f90a5867d4p-1'],
    },
    'static': {
        'ipc': ['0x1.64aaaaaaaaaabp+6', '0x1.0951eb851eb85p+4'],
        'l2_hit_rate': ['0x1.5555555555555p-2', '0x1.d86d35d69602cp-3'],
        'walk_lat': ['0x1.9b3ae2a572bf1p+7', '0x1.5253aa554440ep+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.c90abcc0242afp-1'],
    },
    'mask': {
        'ipc': ['0x1.62c0000000000p+6', '0x1.08bbbbbbbbbbcp+4'],
        'l2_hit_rate': ['0x1.53bd02647c694p-2', '0x1.d0d68a67435a3p-3'],
        'walk_lat': ['0x1.a000000000000p+7', '0x1.53c5f46414040p+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.c922d719c060fp-1'],
    },
    'mask-tlb': {
        'ipc': ['0x1.642aaaaaaaaabp+6', '0x1.0951eb851eb85p+4'],
        'l2_hit_rate': ['0x1.54629b7f0d463p-2', '0x1.ce36b4175b466p-3'],
        'walk_lat': ['0x1.9d6e4630d013fp+7', '0x1.52af50af50af5p+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.c94f90a5867d4p-1'],
    },
    'mask-cache': {
        'ipc': ['0x1.642aaaaaaaaabp+6', '0x1.0951eb851eb85p+4'],
        'l2_hit_rate': ['0x1.54629b7f0d463p-2', '0x1.ce36b4175b466p-3'],
        'walk_lat': ['0x1.9d6e4630d013fp+7', '0x1.52af50af50af5p+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.c94f90a5867d4p-1'],
    },
    'mask-dram': {
        'ipc': ['0x1.62c0000000000p+6', '0x1.08bbbbbbbbbbcp+4'],
        'l2_hit_rate': ['0x1.53bd02647c694p-2', '0x1.d0d68a67435a3p-3'],
        'walk_lat': ['0x1.a000000000000p+7', '0x1.53c5f46414040p+8'],
        'byp_hit_rate': ['0x0.0p+0', '0x0.0p+0'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.c922d719c060fp-1'],
    },
    'mask@9000': {
        'ipc': ['0x1.712aaaaaaaaabp+6', '0x1.5575a56ed1ce6p+4'],
        'l2_hit_rate': ['0x1.3aab8f24fb8c7p-2', '0x1.06a395c6a395cp-2'],
        'walk_lat': ['0x1.36f44b13ee32bp+7', '0x1.76877d6dc735ep+7'],
        'byp_hit_rate': ['0x1.0d29dde11c5eep-6', '0x1.6067bb6ff2802p-8'],
        'tokens': ['0x1.e000000000000p+6', '0x1.e000000000000p+6'],
        'l2c_tlb_hit_rate': ['0x1.de0d0f208e060p-1'],
    },
}

# main-path shapes of the fused round: (sets, ways, lanes, waves)
L2_SHAPE = (1024, 16, 240, 8)        # L2 data cache, every cycle
L2_IDEAL_SHAPE = (1024, 16, 120, 4)  # L2 data cache under `ideal`
PWC_SHAPE = (64, 16, 120, 4)         # page-walk cache under `pwc`
# the reference's kernel-test shapes (tests/test_kernels.py)
KERNEL_TEST_SHAPES = [(1, 64, 30, 1), (32, 16, 30, 3), (64, 8, 64, 4),
                      (4, 2, 24, 6)]
HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
# float32 rate outside the tensor cores (data sheet): the round's integer
# compares run on the same CUDA cores, at no higher a rate
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_FLOPS = 989e12           # dense bf16 tensor-core rate
TF32_TENSOR_FLOPS = 495e12           # dense TF32 tensor-core rate

# the reference's flash attention test sweep (tests/test_kernels.py):
# (S, H, KV, dh, block_q, block_k) x (causal, window) x dtype
FLASH_SHAPES = [(128, 4, 4, 64, 64, 64), (256, 8, 2, 64, 64, 128),
                (128, 4, 1, 128, 32, 64)]
FLASH_MASKS = [(True, None), (False, None), (True, 96)]
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}    # atol = rtol
# the kernels' edges, on both routes (bf16 under the rounding bound, fp32
# at 2e-5): (S, H, KV, dh, causal, window); lengths off the tensor-core
# kernel's 128-row tiles, windows that cross them, non-causal rows, G = H /
# KV of 1, 4 and 8, every head dim (96: phi3-vision's, read as 128 with
# zero-filled columns by the tensor-core kernel)
FLASH_EDGES = [(1000, 4, 4, 128, True, None), (1000, 8, 2, 64, True, 300),
               (1000, 8, 1, 32, False, None), (1000, 16, 2, 128, False, 300),
               (1000, 4, 1, 32, True, 300), (1000, 8, 8, 64, False, None),
               (77, 4, 2, 128, True, 50), (129, 2, 2, 64, False, None),
               (1, 2, 1, 64, True, None), (1000, 8, 2, 96, True, None),
               (129, 4, 4, 96, False, 60)]
FLASH_SOURCES = {"wgmma": "src/repro_torch/csrc/flash_attention_sm90.cu",
                 "split_tf32": "src/repro_torch/csrc/flash_attention.cu"}
TF32_PASSES = 3                      # split TF32: hi.hi + hi.lo + lo.hi
# the serving path's flash call: qwen3-4b prefill of 4 x 2048 tokens
SERVE_ARCH = "qwen3-4b"
MAMBA_ARCH = "mamba2-1.3b"
SERVE_B, SERVE_S, SERVE_NEW = 4, 2048, 64
MATCH_B, MATCH_PROMPT, MATCH_S = 2, 496, 512
MATCH_TOL_PREFILL, MATCH_TOL_DECODE = 2e-3, 5e-3
# the reference's SSD test sweep (tests/test_kernels.py): (S, nh, hd, ds,
# chunk), B=2; then a ragged chunk of 248 rows (S = 496)
SSD_SHAPES = [(64, 4, 16, 16, 16), (128, 8, 32, 16, 32), (96, 2, 64, 32, 32),
              (496, 4, 64, 128, 248)]
# the kernel's own edges, same inputs: chunks past its 4-tile G strip (520
# rows in 3 strips, 300 in 2, 1040 in 5; 1040 is past 768, so it runs the
# instance with cs windows), head counts off its 8-head tile (2, 3, 4, 10),
# widths off 16-byte rows (hd 18, ds 10: 4-byte copies)
SSD_EDGES = [(1040, 4, 64, 128, 520), (300, 10, 64, 128, 300),
             (60, 3, 18, 10, 20), (2080, 2, 64, 128, 1040)]
SSD_TOL = 1e-4
# the serving path's ssd call: mamba2-1.3b prefill of 4 x 2048 tokens
SSD_SERVE = dict(B=4, S=2048, nh=64, hd=64, ds=128, Q=256)
# the reference's paged attention test sweep: (B, H, KV, dh, page, npp)
PAGED_SHAPES = [(4, 8, 4, 64, 16, 6), (2, 4, 4, 128, 32, 4),
                (3, 16, 2, 64, 8, 10)]
# the repo's configs past the sweep: G = H / KV of 16 (glm4-9b) and 12
# (mistral-large-123b) at dh 128, and dh 96 (phi3-vision) at G 16
PAGED_EDGES = [(3, 32, 2, 128, 16, 8), (4, 96, 8, 128, 32, 5),
               (3, 16, 1, 96, 8, 10)]
# the kernel's split (`kernel.split_plan`): the CPU test's split cases
# (tests/test_torch_paged_attention.py SPLIT_CASES: page 5 and 1, 1 and 40
# pages per sequence, lengths at a split boundary and one past it, a
# length 0 among live ones, G 12 and 16, dh 96), then a long one: 64
# pages of 128 per sequence, lengths 1, 128, 129 and 8192.
# (B, H, KV, dh, page, pages per sequence, seq_lens)
PAGED_SPLIT_EDGES = [(3, 8, 2, 64, 5, 60, (300, 125, 126)),
                     (2, 4, 4, 32, 1, 300, (256, 129)),
                     (4, 8, 4, 64, 16, 1, (16, 1, 7, 0)),
                     (3, 16, 2, 128, 8, 40, (320, 128, 129)),
                     (3, 24, 2, 128, 16, 12, (128, 0, 190)),
                     (2, 32, 2, 128, 16, 10, (160, 129)),
                     (3, 8, 8, 96, 16, 20, (320, 129, 0)),
                     (4, 32, 8, 128, 128, 64, (1, 128, 129, 8192))]
PAGED_TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # atol = rtol
# phase 20: the contracts. flash: (S, H, KV, dh, causal, window), B = 2
CONTRACT_FLASH = [(300, 8, 2, 80, True, None), (300, 8, 2, 100, True, 90),
                  (300, 8, 2, 192, False, None), (300, 8, 2, 256, True, None),
                  (129, 8, 1, 256, True, 60), (200, 8, 1, 128, True, None)]
# the timed wide heads: qwen3-4b's flop at dh 256 (B, S, H, KV, dh)
CONTRACT_FLASH_TIMED = (4, 2048, 16, 8, 256)
# paged: (B, H, KV, dh, page, npp) of `paged_inputs`
CONTRACT_PAGED = [(3, 32, 1, 128, 16, 8), (3, 71, 1, 128, 16, 8),
                  (2, 142, 2, 64, 8, 10), (3, 8, 2, 256, 16, 6),
                  (3, 8, 2, 80, 16, 6), (3, 8, 2, 100, 16, 6)]
# the timed groups: phase 11's pool lengths, (B, H, KV, dh, page, npp)
CONTRACT_PAGED_TIMED = [(32, 32, 1, 128, 128, 16), (32, 71, 1, 128, 128, 16)]
# ssd: (S, nh, hd, ds, chunk), B = 2, the reference test's draw
CONTRACT_SSD = [(512, 4, 128, 256, 256), (300, 10, 100, 200, 300),
                (2080, 2, 256, 256, 1040), (128, 8, 128, 64, 64)]
CONTRACT_SSD_TIMED = dict(B=4, S=2048, nh=32, hd=128, ds=256, Q=256)
# fused_tlb: (sets, ways, N, W); 1056 = 8 x 132 cores' lanes
CONTRACT_TLB = [(1024, 16, 1056, 8), (1024, 16, 2048, 8), (64, 16, 1056, 4)]

# the paged pool at qwen3-4b's serving widths
POOL = dict(n_layers=36, page=128, n_kv=8, dh=128, heads=32, seqs=32,
            pages_per_seq=16, n_pages=520, asids=4, steps=8)


def log(msg):
    print(msg, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def path_case(np, sets, ways, N, W, masks, seed):
    """A main-path-like tag-only round: int32-wrapped (mostly negative)
    line tags, each in its set; ~half the lanes re-touch resident lines,
    some repeat their own earlier-wave line."""
    rng = np.random.RandomState(seed)
    hi = rng.randint(-2**21, 2**21, (sets, ways)).astype(np.int64)
    tags = (hi * sets + np.arange(sets)[:, None]).astype(np.int32)
    tags[rng.rand(sets, ways) < 0.1] = -1
    vpn = (rng.randint(-2**21, 2**21, N) * sets
           + rng.randint(0, sets, N)).astype(np.int32)
    pick = tags.reshape(-1)[rng.randint(0, sets * ways, N)]
    vpn = np.where((rng.rand(N) < 0.5) & (pick != -1), pick, vpn)
    C = N // W
    rep = rng.rand(N) < 0.15
    rep[:C] = False
    vpn[rep] = vpn[np.flatnonzero(rep) - C]
    active = {"all": np.ones(N, bool), "half": rng.rand(N) < 0.5,
              "nofill": np.ones(N, bool)}[masks]
    may_fill = np.zeros(N, bool) if masks == "nofill" else rng.rand(N) < 0.8
    return dict(tags=tags, asids=np.zeros((sets, ways), np.int32),
                lru=rng.randint(0, 3000, (sets, ways)).astype(np.int32),
                vpn=vpn.astype(np.int32), asid=np.zeros(N, np.int32),
                active=active, may_fill=may_fill, time=3001,
                n_waves=W, track_asids=False)


def kernel_test_case(np, sets, ways, N, W, track):
    rng = np.random.RandomState(sets * ways + W)
    return dict(tags=rng.randint(-1, 500, (sets, ways)).astype(np.int32),
                asids=rng.randint(0, 3, (sets, ways)).astype(np.int32),
                lru=rng.randint(0, 100, (sets, ways)).astype(np.int32),
                vpn=rng.randint(0, 600, (N,)).astype(np.int32),
                asid=rng.randint(0, 3, (N,)).astype(np.int32),
                active=rng.rand(N) > 0.25, may_fill=rng.rand(N) > 0.2,
                time=77, n_waves=W, track_asids=track)


def collision_case(np, order):
    """Way 0 holds line 8 with the oldest LRU: a fill of the set takes it
    while the other lane pre-hits it; the higher lane must win the slot."""
    return dict(tags=np.asarray([[8, 12, 16, 20]], np.int32),
                asids=np.zeros((1, 4), np.int32),
                lru=np.asarray([[1, 5, 6, 7]], np.int32),
                vpn=np.asarray(order, np.int32), asid=np.zeros(2, np.int32),
                active=np.ones(2, bool), may_fill=np.ones(2, bool), time=50,
                n_waves=1, track_asids=False)


def on_card(torch, case):
    """Fresh CUDA tensors of a case (the round mutates its planes)."""
    keys = ("tags", "asids", "lru", "vpn", "asid", "active", "may_fill")
    return [torch.tensor(case[k], device="cuda") for k in keys], \
        dict(n_waves=case["n_waves"], track_asids=case["track_asids"])


def compare(torch, kernel_fn, plain_fn, case):
    """Kernel vs plain version on one case: returns the max |difference|
    over all five outputs; raises on any mismatch."""
    ka, kw = on_card(torch, case)
    pa, _ = on_card(torch, case)
    got = kernel_fn(*ka, case["time"], **kw)
    want = plain_fn(*pa, case["time"], **kw)
    torch.cuda.synchronize()
    err = 0
    for name, a, b in zip(("tags", "asids", "lru", "hit", "filled"),
                          got, want):
        d = (a.long() - b.long()).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
        if not torch.equal(a, b):
            raise AssertionError(f"fused_tlb kernel != plain version on "
                                 f"{name} ({tuple(case['tags'].shape)}, "
                                 f"N={len(case['vpn'])})")
    return err


def time_round(torch, fn, case, iters):
    """Mean ms per call over `iters` calls after a warm-up, CUDA events."""
    args, kw = on_card(torch, case)
    for _ in range(10):
        fn(*args, case["time"], **kw)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn(*args, case["time"], **kw)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_graph(torch, fn, reps):
    """Device ms per call: `reps` calls of `fn()` captured in one CUDA
    graph and replayed, so no host launch overhead is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def time_round_graph(torch, fn, case, reps):
    """Device ms per round of `fn` on `case`, by `time_graph`."""
    args, kw = on_card(torch, case)
    return time_graph(torch, lambda: fn(*args, case["time"], **kw), reps)


def launch_floor_graph(torch, reps):
    """Device ms of the smallest launch, measured as `time_round_graph`
    measures the round: a captured `x.add_(1)` on a one-element tensor."""
    x = torch.zeros(1, device="cuda")
    return time_graph(torch, lambda: x.add_(1), reps)


def stack_cases(np, cases):
    """Cases of one shape as the rows of one row-axis round."""
    keys = ("tags", "asids", "lru", "vpn", "asid", "active", "may_fill")
    out = dict(cases[0])
    out.update({k: np.stack([c[k] for c in cases]) for k in keys})
    return out


def row_case(case, r):
    keys = ("tags", "asids", "lru", "vpn", "asid", "active", "may_fill")
    return dict(case, **{k: case[k][r] for k in keys})


def bound_rows(np, case, out):
    """`bound` of a row-axis round: the rows' bytes and operations summed."""
    rows = len(case["vpn"])
    work = [round_work(np, row_case(case, r), [x[r] for x in out])
            for r in range(rows)]
    return least_time(sum(w[0] for w in work), sum(w[1] for w in work))


def least_time(nbytes, ops):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def bound(np, case, out):
    """Least time in ms for one round on these inputs, and what bounds it:
    the larger of its bytes over the HBM rate and its operations over the
    CUDA cores' rate. `out` is the round's result on this case (tags,
    asids, lru, hit, filled), as numpy arrays."""
    return least_time(*round_work(np, case, out))


def round_work(np, case, out):
    """(bytes, operations) of one round on these inputs (see `bound`).

    Bytes, counted from this case's data: the tag row (and the asid row
    when tracked) of each set an active lane maps to, and the LRU row of
    each set with a winner, read once; each plane word the round changes,
    written once; the lane inputs read once (vpn, and asid when tracked,
    int32; active, may_fill bool); hit/filled written (int32).
    Operations, counted from this case's data: each active lane compares
    its line with its set's ways twice (probe and post-fill probe; twice
    as many compares with asids), with its own lines of every earlier
    wave, and each winner ranks its set's ways once."""
    sets, ways = case["tags"].shape
    N, W = len(case["vpn"]), case["n_waves"]
    track = case["track_asids"]
    act = np.asarray(case["active"], bool)
    filled = np.asarray(out[4]).astype(bool)
    set_of = np.asarray(case["vpn"], np.int64) % sets    # floor mod
    probed = len(np.unique(set_of[act])) * (2 if track else 1)
    ranked = len(np.unique(set_of[filled]))
    changed = sum(int((np.asarray(new) != case[k]).sum())
                  for k, new in zip(("tags", "asids", "lru"), out[:3]))
    nbytes = ((probed + ranked) * ways * 4 + changed * 4
              + N * (4 * (2 if track else 1) + 2) + N * 8)
    wave = np.arange(N) // (N // W)
    ops = (2 * int(act.sum()) * ways * (2 if track else 1)
           + int(wave[act].sum()) + int(filled.sum()) * ways)
    return nbytes, ops


def flash_inputs(torch, np, S, H, KV, dh, dtype, seed, B=2):
    """The reference test's inputs: numpy normals in (B, S, heads, dh), on
    the card in `dtype`, passed as (B, heads, S, dh) views as the model's
    `ops.flash_attention` passes them."""
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    return [torch.tensor(rng.randn(B, S, n, dh), dtype=torch.float32,
                         device="cuda").to(dt).transpose(1, 2)
            for n in (H, KV, KV)]


def rounding_spread(torch, q, k, v, causal, window, scale=None):
    """sqrt(sum_j p_j^2 v_j^2) for each output element, p the fp32 softmax
    of the plain version (scores times `scale`, by default 1/sqrt(dh)):
    the spread of a sum of per-key rounding errors of p_j v_j."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.float().reshape(B, KV, H // KV, Sq, dh), k.float())
    s = s / dh ** 0.5 if scale is None else s * scale
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    hide = torch.zeros((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        hide |= kpos > qpos
    if window is not None:
        hide |= kpos <= qpos - window
    p = torch.softmax(s.masked_fill(hide, -1e30), dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", p * p,
                        v.float() ** 2).sqrt().reshape(B, H, Sq, -1)


def flash_compare(torch, kernel, ref, q, k, v, causal, window, tol,
                  rounding=False, **blocks):
    """Kernel vs plain version on one case; raises where |difference| >
    tol + tol * |plain|. With `rounding` (bf16), each element is held
    instead to 2^-7 (|o| + 4 sqrt(sum_j p_j^2 v_j^2)), o the plain
    output. Each side rounds its output to bf16, so the two may differ by
    one bf16 step, at most 2^-7 |o|. Each side also rounds every p_j to
    bf16 (at most 2^-8 relative), the kernel before normalising, so the
    two differ per key by up to 2^-7 p_j |v_j|; summed over the row's keys
    that stays within 4 x 2^-7 sqrt(sum_j p_j^2 v_j^2) in the worst case
    for rows of up to 16 keys (Cauchy-Schwarz), and ~10 standard
    deviations out for longer rows. Late rows of a long prompt average
    ~1-2k values of a few hundredths, and there the limit is ~1.5e-3
    against tol's ~2e-2. Returns the max |difference|, its largest share
    of the limit, and the median |o|. A `scale` among `blocks` goes to
    both sides."""
    got = kernel(q, k, v, causal=causal, window=window, **blocks).float()
    scale = {"scale": blocks["scale"]} if "scale" in blocks else {}
    want = ref(q, k, v, causal=causal, window=window, **scale).float()
    if rounding:
        limit = 2.0 ** -7 * (want.abs() + 4 * rounding_spread(
            torch, q, k, v, causal, window, **scale))
    else:
        limit = tol + tol * want.abs()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("flash_attention kernel gave non-finite values")
    err = (got - want).abs()
    share = float((err / limit).max())
    if bool((err > limit).any()):
        what = "the rounding bound" if rounding else f"tol {tol}"
        raise AssertionError(f"flash_attention kernel != plain version: max "
                             f"|err| {float(err.max()):.3g}, {share:.3g}x "
                             f"{what} "
                             f"({tuple(q.shape)}, causal={causal}, "
                             f"window={window}, {q.dtype})")
    return float(err.max()), share, float(want.abs().median())


def visible_pairs(np, Sq, Sk, causal, window):
    """(q, k) pairs the mask lets through: the work of one (batch, head)."""
    qpos = np.arange(Sq)
    hi = np.minimum(qpos, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qpos - window + 1, 0) if window else np.zeros(Sq, int)
    return int(np.maximum(hi - lo + 1, 0).sum())


def time_events(torch, fn, iters, warmup=2):
    """Device ms per call: CUDA events around `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def time_host(torch, fn, iters):
    """Host ms per call from Python, each call synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def routed(kernel, kind, n, what):
    """Raise unless the last `n` launches of `kernel` all took route
    `kind`; the caller zeroed the counts before them."""
    counts = kernel.route_launches
    want = {name: (n if name == kind else 0) for name in counts}
    if kernel.launches != n or counts != want:
        raise AssertionError(f"flash_attention {what}: {kernel.launches} "
                             f"launches, by route {counts}; want {want}")


def zero_counts(kernel):
    kernel.launches = 0
    for name in kernel.route_launches:
        kernel.route_launches[name] = 0


def flash_timing(torch, np, kernel, q, k, v, flop_rate, passes=1):
    """The kernel's device time (CUDA events), its time per launch from
    Python, the plain version's time and `scaled_dot_product_attention`'s
    on causal q, k, v, with the bound: the larger of the visible pairs'
    flop, times the `passes` each product takes, over `flop_rate` and q,
    k, v, o's bytes over the HBM rate. `tflops` counts the visible pairs'
    flop once."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_ref
    B, H, S, dh = q.shape
    KV = k.shape[1]
    run = lambda: kernel(q, k, v, causal=True)           # noqa: E731
    ms = time_events(torch, run, 20)
    launch_ms = time_host(torch, run, 10)
    plain_ms = time_events(torch, lambda: attention_ref(q, k, v), 3, 1)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    if tuple(int(x) for x in torch.__version__.split(".")[:2]) >= (2, 5):
        lib = lambda: F.scaled_dot_product_attention(    # noqa: E731
            qc, kc, vc, is_causal=True, enable_gqa=True)
    else:
        kr, vr = (t.repeat_interleave(H // KV, dim=1) for t in (kc, vc))
        lib = lambda: F.scaled_dot_product_attention(    # noqa: E731
            qc, kr, vr, is_causal=True)
    library_ms = time_events(torch, lib, 20)
    flops = 4 * dh * B * H * visible_pairs(np, S, S, True, None)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    by_ops = passes * flops / flop_rate * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes \
        else (by_bytes, "bytes")
    return dict(ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, nbytes=nbytes, bytes_ms=by_bytes,
                tflops=flops / ms / 1e9, bound_share=bound_ms / ms)


def flash_phase(torch, np, kernel, card):
    """Phase 5: the flash kernels against their plain version, each on the
    route its dtype selects, and their times: the wgmma kernel at the
    serving shape, the split-TF32 kernel at phase 7's fp32 shape. Returns
    the two entries of the JSON line (launches filled in by phases 6 and
    7)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    errs = {"float32": [], "bfloat16": []}
    shares = {"float32": [], "bfloat16": []}
    for dtype, kind in (("float32", "split_tf32"), ("bfloat16", "wgmma")):
        zero_counts(kernel)
        for S, H, KV, dh, bq, bk in FLASH_SHAPES:
            q, k, v = flash_inputs(torch, np, S, H, KV, dh, dtype, S + H)
            for causal, window in FLASH_MASKS:
                err, share, _ = flash_compare(
                    torch, kernel, attention_ref, q, k, v, causal, window,
                    FLASH_TOL[dtype], block_q=bq, block_k=bk)
                errs[dtype].append(err)
                shares[dtype].append(share)
        routed(kernel, kind, len(FLASH_SHAPES) * len(FLASH_MASKS),
               f"{dtype} sweep")
    log(f"[flash] kernel == plain version on the reference's "
        f"{sum(map(len, errs.values()))} sweep cases (max |err| "
        f"{max(errs['float32']):.3g} fp32 on the split_tf32 route, largest "
        f"share {max(shares['float32']):.3g} of tol 2e-5; "
        f"{max(errs['bfloat16']):.3g} bf16 on the wgmma route) [{card}]")
    for dtype, kind in (("float32", "split_tf32"), ("bfloat16", "wgmma")):
        zero_counts(kernel)                   # phase 7's ragged prefill
        q, k, v = flash_inputs(torch, np, MATCH_PROMPT, 32, 8, 128, dtype, 1,
                               B=MATCH_B)
        bf16 = dtype == "bfloat16"
        err, share, typical = flash_compare(
            torch, kernel, attention_ref, q, k, v, True, None,
            FLASH_TOL[dtype], bf16)
        routed(kernel, kind, 1, f"B={MATCH_B} S={MATCH_PROMPT} {dtype}")
        errs[dtype].append(err)
        shares[dtype].append(share)
        log(f"[flash] B={MATCH_B} S={MATCH_PROMPT} causal {dtype} ({kind}): "
            f"max |err| {err:.3g}, {share:.3g}x "
            f"{'the rounding bound' if bf16 else 'tol'}; median |o| "
            f"{typical:.3g}")
    edge_shares = {}
    for dtype, kind in (("float32", "split_tf32"), ("bfloat16", "wgmma")):
        zero_counts(kernel)
        bf16 = dtype == "bfloat16"
        edge_shares[dtype] = []
        for S, H, KV, dh, causal, window in FLASH_EDGES:
            q, k, v = flash_inputs(torch, np, S, H, KV, dh, dtype, S + dh)
            err, share, _ = flash_compare(
                torch, kernel, attention_ref, q, k, v, causal, window,
                FLASH_TOL[dtype], rounding=bf16, block_q=S, block_k=S)
            errs[dtype].append(err)
            edge_shares[dtype].append(share)
        shares[dtype] += edge_shares[dtype]
        routed(kernel, kind, len(FLASH_EDGES), f"{dtype} edge cases")
    log(f"[flash] kernels == plain version on {len(FLASH_EDGES)} edge cases "
        f"each (ragged S, windows across tile edges, non-causal, G 1 to 8, "
        f"dh 32/64/96/128): wgmma within the rounding bound (largest share "
        f"{max(edge_shares['bfloat16']):.3g}), split_tf32 within tol 2e-5 "
        f"(largest share {max(edge_shares['float32']):.3g}); fp32 over the "
        f"sweep, the ragged prefill and the edges: largest share "
        f"{max(shares['float32']):.3g} of 2e-5 [{card}]")

    B, S, H, KV, dh = SERVE_B, SERVE_S, 32, 8, 128
    q, k, v = flash_inputs(torch, np, S, H, KV, dh, "bfloat16", 0, B=B)
    zero_counts(kernel)
    err, share, typical = flash_compare(
        torch, kernel, attention_ref, q, k, v, True, None,
        FLASH_TOL["bfloat16"], rounding=True)
    routed(kernel, "wgmma", 1, "serving shape")
    errs["bfloat16"].append(err)
    tc = flash_timing(torch, np, kernel, q, k, v, BF16_TENSOR_FLOPS)
    log(f"[flash] B={B} S={S} H={H} KV={KV} dh={dh} causal bf16 (wgmma "
        f"route, {FLASH_SOURCES['wgmma']}): max |err| "
        f"{err:.3g}, {share:.3g}x the rounding bound; median |o| "
        f"{typical:.3g}; kernel "
        f"{tc['ms']:.4f} ms on the device ({tc['tflops']:.1f} TFLOP/s, "
        f"{tc['bound_share']:.3f} of the bound), {tc['launch_ms']:.4f} ms "
        f"per launch from Python; plain version {tc['plain_ms']:.3f} ms; "
        f"scaled_dot_product_attention {tc['library_ms']:.4f} ms; bound "
        f"{tc['bound_ms']:.4f} ms by {tc['bound_by']} ({tc['flops']:.4g} "
        f"flop, {tc['nbytes']:.4g} B) [{card}]")
    del q, k, v
    q, k, v = flash_inputs(torch, np, MATCH_PROMPT, 32, 8, 128, "float32", 1,
                           B=MATCH_B)
    fp = flash_timing(torch, np, kernel, q, k, v, TF32_TENSOR_FLOPS,
                      TF32_PASSES)
    fp["bound_cuda_core_ms"] = fp["flops"] / CUDA_CORE_OPS_PER_S * 1e3
    log(f"[flash] B={MATCH_B} S={MATCH_PROMPT} H=32 KV=8 dh=128 causal fp32 "
        f"(split_tf32 route, {FLASH_SOURCES['split_tf32']}): kernel "
        f"{fp['ms']:.4f} ms on the device ({fp['tflops']:.2f} TFLOP/s of "
        f"attention, {fp['bound_share']:.3f} of the bound), "
        f"{fp['launch_ms']:.4f} ms per launch from Python; plain version "
        f"{fp['plain_ms']:.3f} ms; scaled_dot_product_attention in fp32 "
        f"{fp['library_ms']:.4f} ms; bounds side by side: split-TF32 "
        f"products {fp['bound_ms']:.4f} ms by {fp['bound_by']} "
        f"({TF32_PASSES} x {fp['flops']:.4g} flop at the TF32 tensor cores' "
        f"495 TFLOP/s), the SIMT kernel's CUDA-core fp32 bound "
        f"{fp['bound_cuda_core_ms']:.4f} ms ({fp['flops']:.4g} flop at 67 "
        f"TFLOP/s); bytes {fp['nbytes']:.4g} B, {fp['bytes_ms']:.4f} ms "
        f"[{card}]")
    del q, k, v
    torch.cuda.empty_cache()
    entries = []
    for name, kind, dtype, t, shape in (
            ("flash_attention", "wgmma", "bfloat16", tc,
             {"B": B, "S": S, "H": H, "KV": KV, "dh": dh}),
            ("flash_attention_fp32", "split_tf32", "float32", fp,
             {"B": MATCH_B, "S": MATCH_PROMPT, "H": 32, "KV": 8, "dh": 128})):
        entries.append({
            "name": name, "route": "cuda", "kernel": kind,
            "source": FLASH_SOURCES[kind],
            "replaces": "src/repro/kernels/flash_attention/kernel.py:26",
            "launches": None, "max_abs_err": max(errs[dtype]),
            "ms": t["ms"], "launch_ms": t["launch_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "tflops": t["tflops"], "bound_share": t["bound_share"],
            "cases": len(errs[dtype]),
            "shape": dict(shape, dtype=dtype, causal=True)})
    return entries


def model_setup(torch, dtype, arch=SERVE_ARCH, cfg=None):
    """`arch` (qwen3-4b) at full width on the card, or `cfg` (a config cut
    in depth), seeded random weights in `dtype` (None: each leaf's own
    dtype, bf16 weights), `attention_impl="pallas_flash"`."""
    from repro_torch.configs import get_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model
    cfg = cfg or get_model(arch)
    run = RunConfig(model=cfg, shape=ShapeConfig(
        "serve", SERVE_S, SERVE_B, "prefill"), remat=False,
        attention_impl="pallas_flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init_params(gen, cfg, device="cuda", dtype_override=dtype)
    return model, cfg, run, params


def serve_tokens(torch, np, cfg):
    """The serving path's prompts: SERVE_B x SERVE_S tokens, numpy seed 0."""
    rng = np.random.RandomState(0)
    return torch.tensor(rng.randint(0, cfg.vocab_size, (SERVE_B, SERVE_S)),
                        dtype=torch.int32, device="cuda")


def finite(torch, x, what):
    if not bool(torch.isfinite(x.float()).all()):
        raise AssertionError(f"{what}: non-finite logits")


def serve_phase(torch, np, card, arch=SERVE_ARCH, tag="serve"):
    """Phases 6 and 9: prefill + greedy decode of `arch` at full width,
    bf16. Returns the first prefill's logits on the host (phase 18 (c)
    holds its sharded prefill to them)."""
    from repro_torch.models.params import count_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, cfg, run, params = model_setup(torch, None, arch)
    torch.cuda.synchronize()
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{count_params(params) / 1e9:.3f} B params "
        f"in bf16 on the card in {time.perf_counter() - t0:.2f} s")
    tokens = serve_tokens(torch, np, cfg)
    max_len = SERVE_S + SERVE_NEW
    times = []
    for _ in range(2):                       # cold, then timed
        t0 = time.perf_counter()
        logits, caches = model.forward_prefill(
            cfg, run, params, {"tokens": tokens}, max_len=max_len)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        finite(torch, logits, "prefill")
        if logits.shape != (SERVE_B, 1, cfg.padded_vocab):
            raise AssertionError(f"prefill logits {tuple(logits.shape)}")
        if not times[1:]:
            first = logits.cpu()
    t0 = time.perf_counter()
    for _ in range(SERVE_NEW):
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).int()
        logits, caches = model.forward_decode(cfg, run, params,
                                              {"tokens": tok}, caches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    finite(torch, logits, "decode")
    if caches["cache_len"].tolist() != [max_len] * SERVE_B:
        raise AssertionError(f"cache_len {caches['cache_len'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] prefill {SERVE_B} x {SERVE_S} tokens: {times[0] * 1e3:.1f} "
        f"ms cold, {times[1] * 1e3:.1f} ms warm; decode {SERVE_NEW} steps: "
        f"{decode_s * 1e3 / SERVE_NEW:.2f} ms per step, "
        f"{SERVE_B * SERVE_NEW / decode_s:.1f} tokens/s; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    del params, caches, logits
    torch.cuda.empty_cache()
    return first


def match_phase(torch, np, card, arch=SERVE_ARCH, tag="match", cfg=None):
    """Phases 7 and 10 (and 15, 16 on configs cut in depth): prefill +
    decode == forward_train, full width, fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, cfg, run, params = model_setup(torch, torch.float32, arch, cfg)
    rng = np.random.RandomState(1)
    tokens = torch.tensor(rng.randint(0, cfg.vocab_size, (MATCH_B, MATCH_S)),
                          dtype=torch.int32, device="cuda")
    full, _ = model.forward_train(cfg, run, params, {"tokens": tokens})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = model.forward_prefill(
        cfg, run, params, {"tokens": tokens[:, :MATCH_PROMPT]},
        max_len=MATCH_S)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite(torch, full, "forward_train")
    err_prefill = float((logits[:, -1] - full[:, MATCH_PROMPT - 1]).abs()
                        .max())
    err_decode = 0.0
    for i in range(MATCH_PROMPT, MATCH_S):
        logits, caches = model.forward_decode(
            cfg, run, params, {"tokens": tokens[:, i:i + 1]}, caches)
        err_decode = max(err_decode, float(
            (logits[:, 0] - full[:, i]).abs().max()))
    scale = float(full.abs().max())
    log(f"[{tag}] {cfg.name} fp32, TF32 off: prefill of {MATCH_B} x {MATCH_PROMPT} "
        f"tokens + {MATCH_S - MATCH_PROMPT} decode steps vs forward_train "
        f"over {MATCH_S}: max |err| {err_prefill:.3g} (prefill, tol "
        f"{MATCH_TOL_PREFILL}), {err_decode:.3g} (decode, tol "
        f"{MATCH_TOL_DECODE}); max |logit| {scale:.3g}; the prefill "
        f"{prefill_ms:.2f} ms (one call, after forward_train) [{card}]")
    if not (err_prefill < MATCH_TOL_PREFILL and err_decode < MATCH_TOL_DECODE):
        raise AssertionError(f"{cfg.name}: prefill + decode != "
                             "forward_train")
    del params, caches, logits, full
    torch.cuda.empty_cache()


def ssd_compare(torch, kernel, ref, args, tol=None):
    """Kernel vs plain version on one case: every output within tol +
    tol * |plain| or, without tol, within `ref.ssd_limits`. Returns the max
    |difference| and its largest share of the limit; raises on a miss."""
    from repro_torch.kernels.ssd_scan.ref import ssd_limits
    got = kernel(*args)
    want = ref(*args)
    if tol is None:
        limits = ssd_limits(*args)
    else:
        limits = [tol + tol * w.abs() for w in want]
    torch.cuda.synchronize()
    err, share = 0.0, 0.0
    for name, g, w, lim in zip(("y", "S", "decay"), got, want, limits):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"ssd kernel gave non-finite {name}")
        d = (g - w).abs()
        err = max(err, float(d.max()))
        share = max(share, float((d / lim).max()))
        if bool((d > lim).any()):
            raise AssertionError(f"ssd kernel != plain version on {name}: "
                                 f"max |err| {float(d.max()):.3g}, "
                                 f"{float((d / lim).max()):.3g}x the limit "
                                 f"({tuple(args[0].shape)})")
    if tol is None:     # the limit must not pass a wrong head or q tile
        for wrong in (want[0].roll(1, dims=3), want[0].roll(64, dims=2)):
            if not bool(((got[0] - wrong).abs() > limits[0]).any()):
                raise AssertionError("ssd limit passes a wrong head or tile")
    return err, share


def ssd_phase(torch, np, card):
    """Phase 8: the ssd kernel against its plain version, and its times at
    the serving shape. Returns the kernel's entry of the JSON line."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import (ssd_intra_chunk_ref,
                                                  ssd_recurrence_ref)
    errs = []
    for S, nh, hd, ds, chunk in SSD_SHAPES + SSD_EDGES:
        rng = np.random.RandomState(S + nh)        # the reference test's
        arrays = [rng.randn(2, S, nh, hd) * .5,
                  np.abs(rng.randn(2, S, nh)) * .1 + .02,
                  -np.abs(rng.randn(nh)) * .5 - .1,
                  rng.randn(2, S, ds) * .5, rng.randn(2, S, ds) * .5]
        x, dt, A, B, C = (torch.tensor(a, dtype=torch.float32, device="cuda")
                          for a in arrays)
        errs.append(ssd_compare(torch, ssd_intra_chunk, ssd_intra_chunk_ref,
                                ops.chunk_inputs(x, dt, A, B, C, chunk),
                                SSD_TOL)[0])
        y, h = ops.ssd_scan(x, dt, A, B, C, chunk=chunk)
        y_ref, h_ref = ssd_recurrence_ref(x, dt, A, B, C)
        for got, want in ((y, y_ref), (h, h_ref)):
            if not bool(((got - want).abs()
                         <= SSD_TOL + SSD_TOL * want.abs()).all()):
                raise AssertionError(f"ops.ssd_scan != recurrence (S={S})")
    log(f"[ssd] kernel == plain version on the reference's 3 sweep cases, "
        f"a ragged chunk of 248 rows and {len(SSD_EDGES)} edge cases (chunks "
        f"of 520, 300 and 1040 rows, 2, 3, 4 and 10 heads, hd 18 / ds 10) (atol = rtol "
        f"= {SSD_TOL}; max |err| {max(errs):.3g}); ops.ssd_scan == the O(S) "
        f"recurrence on all [{card}]")

    sv = SSD_SERVE
    B_, S, nh, hd, ds, Q = (sv[k] for k in ("B", "S", "nh", "hd", "ds", "Q"))
    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, B, C = draw(B_, S, nh, hd) * .5, draw(B_, S, ds) * .5, \
        draw(B_, S, ds) * .5
    dt = torch.rand((B_, S, nh), generator=gen, device="cuda") * .1 + .02
    A = -(torch.rand((nh,), generator=gen, device="cuda") * .5 + .1)
    args = ops.chunk_inputs(x, dt, A, B, C, Q)
    err, share = ssd_compare(torch, ssd_intra_chunk, ssd_intra_chunk_ref,
                             args)
    errs.append(err)
    run = lambda: ssd_intra_chunk(*args)                  # noqa: E731
    ms = time_events(torch, run, 20)
    launch_ms = time_host(torch, run, 10)
    plain_ms = time_events(torch, lambda: ssd_intra_chunk_ref(*args), 3, 1)
    nc, pairs = S // Q, Q * (Q + 1) // 2
    # the products, per (b, chunk): G on the s <= q pairs once (2 ds flop a
    # pair); per head y (2 hd a pair) and S (2 Q hd ds). The kernel runs
    # each in split TF32, three tensor-core passes. The elementwise ops per
    # head: M = G L (a multiply and an exp a pair), the decay-weighted x
    # (Q hd), the cumsum (Q)
    products = B_ * nc * (2 * ds * pairs + nh * (
        2 * hd * pairs + 2 * Q * hd * ds))
    elementwise = B_ * nc * nh * (2 * pairs + Q * hd + Q)
    nbytes = 4 * (2 * args[0].numel() + args[1].numel() + args[2].numel()
                  + args[3].numel() + B_ * nc * nh * (hd * ds + 1))
    terms = {"operations": max(3 * products / TF32_TENSOR_FLOPS,
                               elementwise / CUDA_CORE_OPS_PER_S) * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    bound_by = max(terms, key=terms.get)
    bound_ms = terms[bound_by]
    # the fp32 CUDA-core bound of the kernel it replaced (products and
    # elementwise ops at 67 TFLOP/s), printed beside the new one
    fp32_bound_ms = max((products + elementwise) / CUDA_CORE_OPS_PER_S,
                        nbytes / HBM_BYTES_PER_S) * 1e3
    log(f"[ssd] B={B_} S={S} nh={nh} hd={hd} ds={ds} Q={Q} fp32: max |err| "
        f"{err:.3g}, {share:.3g}x the sum-of-|terms| limit; kernel "
        f"{ms:.4f} ms on the device ({bound_ms / ms:.3f} of the bound), "
        f"{launch_ms:.4f} ms per launch from Python; plain version "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({products:.4g} flop of products x 3 split-TF32 passes at 495 "
        f"TFLOP/s: {3 * products / TF32_TENSOR_FLOPS * 1e3:.4f} ms; "
        f"{elementwise:.4g} elementwise ops at 67 TFLOP/s: "
        f"{elementwise / CUDA_CORE_OPS_PER_S * 1e3:.4f} ms; {nbytes:.4g} B "
        f"at 3.35 TB/s: {terms['bytes']:.4f} ms); the fp32 CUDA-core bound "
        f"{fp32_bound_ms:.4f} ms [{card}]")
    del x, B, C, dt, args
    torch.cuda.empty_cache()
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/kernel.py:29",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "launch_ms": launch_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "bound_share": bound_ms / ms,
            "cases": len(errs), "shape": dict(sv, dtype="float32")}


def dense_decode(torch, q, k, v, lens):
    """One-token attention over contiguous k/v (B, T, KV, dh), written
    apart from the paged code: an fp32 softmax over positions < lens (a
    length-0 row gives 0), p rounded to v's dtype before p.v. Returns the
    output (B, H, dh) in fp32 and sqrt(sum_j p_j^2 v_j^2), the spread of
    the per-key rounding errors that `flash_compare`'s limit uses."""
    B, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    s = torch.einsum("bkgd,btkd->bkgt", q.float().reshape(B, KV, H // KV, dh),
                     k.float()) / dh ** 0.5
    live = torch.arange(T, device=q.device)[None, :] < lens[:, None]
    p = torch.softmax(s.masked_fill(~live[:, None, None, :], float("-inf")),
                      dim=-1).nan_to_num(0.0)
    o = torch.einsum("bkgt,btkd->bkgd", p.to(v.dtype).float(), v.float())
    spread = torch.einsum("bkgt,btkd->bkgd", p * p, v.float() ** 2).sqrt()
    return o.reshape(B, H, dh), spread.reshape(B, H, dh)


def rounding_check(torch, got, want, spread, what):
    """`flash_compare`'s bf16 limit, 2^-7 (|want| + 4 spread); returns the
    max |difference| and its largest share of the limit."""
    err = (got.float() - want.float()).abs()
    limit = 2.0 ** -7 * (want.float().abs() + 4 * spread)
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{what}: non-finite output")
    if bool((err > limit).any()):
        raise AssertionError(f"{what}: max |err| {float(err.max()):.3g}, "
                             f"{float((err / limit).max()):.3g}x the "
                             "rounding bound")
    return float(err.max()), float((err / limit).max())


def paged_inputs(torch, np, B, H, KV, dh, page, npp, dtype, lens=None):
    """q, k/v pages, block table, seq_lens on the card: the reference
    test's seeded draw (random lengths) or a split case's (given ones)."""
    rng = np.random.RandomState(B * H if lens is None else B * H + page * npp)
    P = npp * B + 4
    dt = getattr(torch, dtype)
    q, kp, vp = (torch.tensor(a, dtype=torch.float32, device="cuda").to(dt)
                 for a in (rng.randn(B, H, dh), rng.randn(P, page, KV, dh),
                           rng.randn(P, page, KV, dh)))
    bt = torch.tensor(rng.choice(P, (B, npp), replace=False),
                      dtype=torch.int32, device="cuda")
    if lens is None:
        lens = rng.randint(1, npp * page + 1, B)
    sl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, sl


def paged_cases():
    """Every check case of the paged kernel, as `paged_inputs`' arguments
    after (torch, np): the sweep, PAGED_EDGES, PAGED_SPLIT_EDGES, in both
    dtypes."""
    return [case + (dtype,) + extra
            for dtype in ("float32", "bfloat16")
            for case, extra in ([(c, ()) for c in PAGED_SHAPES + PAGED_EDGES]
                                + [(c[:6], (c[6],))
                                   for c in PAGED_SPLIT_EDGES])]


def paged_check(torch, np, fn, ref):
    """`fn` against the plain version `ref` on every case of
    `paged_cases`, at PAGED_TOL; returns each case's max |err|."""
    errs = []
    for case in paged_cases():
        args = paged_inputs(torch, np, *case)
        got = fn(*args).float()
        want = ref(*args).float()
        torch.cuda.synchronize()
        err = (got - want).abs()
        errs.append(float(err.max()))
        tol = PAGED_TOL[case[6]]
        if bool((err > tol + tol * want.abs()).any()):
            raise AssertionError(f"paged kernel != plain version {case}: "
                                 f"max |err| {errs[-1]:.3g}")
    return errs


def pool_lens(np):
    """The pool's prompt lengths: seeded, up to 2040, with 128, 1024 and
    1920 among them (their first decode token opens a page)."""
    page, steps = POOL["page"], POOL["steps"]
    rng = np.random.RandomState(11)
    lens = rng.randint(1, POOL["pages_per_seq"] * page - steps + 1,
                       POOL["seqs"])
    lens[:3] = (page, 8 * page, 15 * page)
    return lens


def paged_phase(torch, np, card):
    """Phase 11: the paged kernel against its plain version, then the
    paged pool's decode read at qwen3-4b's widths. Returns the kernel's
    entry of the JSON line."""
    from repro_torch.kernels.paged_attention import ops
    from repro_torch.kernels.paged_attention.kernel import (paged_attention,
                                                            split_plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    from repro_torch.memmgr import kv_cache as kvc
    errs = paged_check(torch, np, paged_attention, paged_attention_ref)
    log(f"[paged] kernel == plain version on {len(paged_cases())} checks: "
        f"the reference's {len(PAGED_SHAPES)} sweep cases, "
        f"{len(PAGED_EDGES)} edge cases (G 16 and 12 at dh 128, dh 96) and "
        f"{len(PAGED_SPLIT_EDGES)} split cases (page 5 and 1, 1 to 64 pages "
        f"per sequence, lengths at and one past a split boundary, length "
        f"0, lengths 1 to 8192), each in fp32 and bf16 (atol = rtol = 2e-5 "
        f"fp32, 3e-2 bf16; max |err| {max(errs):.3g}) [{card}]")

    L, page, KV, dh, H = (POOL[k] for k in ("n_layers", "page", "n_kv", "dh",
                                            "heads"))
    nseq, pps, steps = POOL["seqs"], POOL["pages_per_seq"], POOL["steps"]
    cfg = kvc.PoolConfig(n_pages=POOL["n_pages"], page_size=page, n_kv=KV,
                         head_dim=dh, n_layers=L, max_seqs=nseq,
                         pages_per_seq=pps)
    torch.cuda.reset_peak_memory_stats()
    pool = kvc.init(cfg, device="cuda")
    lens = pool_lens(np)
    for slot, ln in enumerate(lens):
        pool, ok = kvc.admit_seq(cfg, pool, slot, slot % POOL["asids"],
                                 int(ln))
        if not bool(ok):
            raise AssertionError(f"admit_seq refused slot {slot} ({ln})")
    # the script's own contiguous copy of every token's K/V, and the prompt
    # tokens written into the pool through the block table
    T = pps * page
    gen = torch.Generator(device="cuda").manual_seed(11)
    kc = torch.empty((L, nseq, T, KV, dh), dtype=torch.bfloat16,
                     device="cuda")
    vc = torch.empty_like(kc)
    for copy in (kc, vc):
        for layer in range(L):
            copy[layer] = torch.randn((nseq, T, KV, dh), generator=gen,
                                      device="cuda")
    slots = torch.arange(nseq, dtype=torch.int32, device="cuda")
    leaf = kvc.gather_block_table(cfg, pool, slots).long()
    b_idx = torch.cat([torch.full((int(n),), b) for b, n in enumerate(lens)]
                      ).cuda()
    t_idx = torch.cat([torch.arange(int(n)) for n in lens]).cuda()
    phys, off = leaf[b_idx, t_idx // page], t_idx % page
    for layer in range(L):
        pool.k[layer][phys, off] = kc[layer][b_idx, t_idx]
        pool.v[layer][phys, off] = vc[layer][b_idx, t_idx]

    paged_attention.launches = 0
    shares, t0 = [], time.perf_counter()
    for step in range(steps):
        for slot in range(nseq):
            pool, ok = kvc.append_token_alloc(cfg, pool, slot)
            if not bool(ok):
                raise AssertionError(f"append_token_alloc refused {slot}")
        seq_lens = pool.seq_lens[slots.long()]
        table = kvc.gather_block_table(cfg, pool, slots)
        pos = (seq_lens - 1).long()
        gathered = table.long()
        for layer in range(L):
            k_new = torch.randn((nseq, KV, dh), generator=gen, device="cuda")
            v_new = torch.randn((nseq, KV, dh), generator=gen, device="cuda")
            pool, fault = kvc.write_kv(cfg, pool, layer, slots, k_new, v_new)
            kc[layer][slots.long(), pos] = k_new.to(torch.bfloat16)
            vc[layer][slots.long(), pos] = v_new.to(torch.bfloat16)
            q = torch.randn((nseq, H, dh), generator=gen, device="cuda"
                            ).to(torch.bfloat16)
            out = ops.paged_attention(q, pool.k[layer], pool.v[layer], table,
                                      seq_lens)
            plain = paged_attention_ref(q, pool.k[layer], pool.v[layer],
                                        table, seq_lens)
            kg = pool.k[layer][gathered].reshape(nseq, T, KV, dh)
            vg = pool.v[layer][gathered].reshape(nseq, T, KV, dh)
            _, spread = dense_decode(torch, q, kg, vg, seq_lens)
            err, share = rounding_check(
                torch, out, plain, spread,
                f"paged kernel != plain version (step {step}, layer {layer})")
            errs.append(err)
            shares.append(share)
            if bool(fault.any()):
                raise AssertionError(f"write_kv faulted at step {step}")
            if step == steps - 1:      # the pool holds what was written
                dense, spread_c = dense_decode(torch, q, kc[layer],
                                               vc[layer], seq_lens)
                rounding_check(torch, plain, dense, spread_c,
                               f"plain version != dense attention over the "
                               f"contiguous copy (layer {layer})")
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    launches = paged_attention.launches
    if launches != L * steps:
        raise AssertionError(f"paged_attention launched {launches} times in "
                             f"{steps} steps of {L} layers")
    want_lens = torch.tensor(lens + steps, dtype=torch.int32, device="cuda")
    if not torch.equal(seq_lens, want_lens):
        raise AssertionError("pool lengths != prompt + decode steps")
    pressure = kvc.pool_pressure(cfg, pool)
    peak = torch.cuda.max_memory_allocated()
    log(f"[paged] pool {L} layers x {cfg.n_pages} pages x {page} tokens x "
        f"{KV} x {dh} bf16 ({2 * pool.k.numel() * 2 / 1e9:.2f} GB of K+V); "
        f"{nseq} sequences under {POOL['asids']} ASIDs, {int(lens.sum())} "
        f"prompt tokens, {pressure.free_pages} pages free after {steps} "
        f"steps; {launches} launches == {L} x {steps}, each == plain "
        f"version (largest share of the rounding bound {max(shares):.3g}); "
        f"plain == dense attention over the contiguous copy at the last "
        f"step; {loop_s:.2f} s for the loop with its checks; peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")

    layer = L - 1                       # one layer's launch, last step
    args = (q, pool.k[layer], pool.v[layer], table, seq_lens)
    run = lambda: paged_attention(*args)                  # noqa: E731
    split_pages, n_splits = split_plan(page, pps)
    live = int(((seq_lens + page * split_pages - 1)
                // (page * split_pages)).sum()) * KV
    if not torch.equal(run(), run()):
        raise AssertionError("paged_attention differs between two runs")
    log(f"[paged] split plan at the pool's shape: {split_pages} page(s) of "
        f"{page} tokens per block, {n_splits} splits per (KV head, "
        f"sequence); grid {n_splits} x {KV} x {nseq} = "
        f"{n_splits * KV * nseq} blocks, {live} of them on live pages; "
        f"then one combine block per (query head, sequence); two runs "
        f"equal bit for bit")
    ms = time_events(torch, run, 20)
    launch_ms = time_host(torch, run, 10)
    plain_ms = time_events(torch, lambda: paged_attention_ref(*args), 3, 1)
    tokens = int(seq_lens.sum())
    nbytes = (2 * tokens * KV * dh * 2          # live K and V, bf16
              + 2 * q.numel() * 2 + table.numel() * 4 + nseq * 4)
    flops = 4 * H * dh * tokens                 # q.k and p.v
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / BF16_TENSOR_FLOPS * 1e3
    bound_ms, bound_by = (by_bytes, "bytes") if by_bytes >= by_ops \
        else (by_ops, "operations")
    log(f"[paged] one layer's launch, B={nseq} H={H} KV={KV} dh={dh} page="
        f"{page}, {tokens} live tokens, bf16: kernel {ms:.4f} ms on the "
        f"device (split + combine, two CUDA launches per call), "
        f"{launch_ms:.4f} ms per call from Python; plain version "
        f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms by {bound_by} "
        f"({nbytes:.4g} B at 3.35 TB/s, {flops:.4g} flop) [{card}]")
    del pool, kc, vc, kg, vg
    torch.cuda.empty_cache()
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention/kernel.py:31",
            "launches": launches, "max_abs_err": max(errs), "ms": ms,
            "launch_ms": launch_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "cases": len(errs),
            "shape": {"B": nseq, "H": H, "KV": KV, "dh": dh, "page": page,
                      "pages_per_seq": pps, "live_tokens": tokens,
                      "dtype": "bfloat16"}}


GRID_ROWS_CHECKED = (1, 3, 16)       # row counts of the kernel check
GRID_ROWS_TIMED = 40                 # rows of the timed row-axis round
GRID_GROUP_ROWS = 21                 # 7 designs x 3 mixes: one grouped pass
GRID_MIXES = [("3DS", "BLK"), ("3DS", None), ("BLK", None)]
GRID_LOOP = (("ideal", "pwc", "mask"), [("3DS", None), ("BLK", None)], 300)
SWEEP = (["ideal", "gpu-mmu", "mask"], [("3DS", "BLK"), ("MUM", "RED")],
         300)
GRID_RATE_ROWS, GRID_RATE_CYCLES = (1, 8, 40), 300
GRID_PROFILE_STEPS = 50
# the 8 designs x 5 pairs, as 2 grouped passes and as 8 one-design passes
GRID_DESIGN_MIXES, GRID_DESIGN_CYCLES = 5, 300
# dispatcher operations of one eager step of phase 4's one-design `mask`
# pass as the step issued them before per-row design knobs came in, plus
# the 9 that reading the cycle from the device scalar `state.t` adds (the
# fused round counted as one call): (an epoch step, a step between
# epochs); the CPU test pins the same counts for every built-in design
# (tests/test_torch_grid_designs.py PARENT_STEP_OPS)
PARENT_MASK_STEP_OPS = (906, 854)


def grid_rows():
    """The 40 rows of the throughput pass: the 20 pairs of
    `pair_workloads(n_pairs=20)` and the solo rows of the first 20 of
    their 22 benches."""
    from repro_torch.sim.workloads import pair_workloads
    pairs = pair_workloads(n_pairs=20)
    benches = sorted({b for m in pairs for b in m})
    rows = pairs + [(b, None) for b in benches]
    return rows[:GRID_ROWS_TIMED]


def profile_steps(torch, cfg, dp, pm, st, cycle, steps):
    """A `torch.profiler` window of `steps` cycles: (device ms per step,
    kernels per step, wall ms per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.sim import memsys
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with torch.inference_mode():
            for _ in range(steps):
                st = memsys.step(cfg, dp, pm, st, cycle)
                cycle += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dev_ms / steps, len(kernels) / steps, wall * 1e3 / steps


def step_ops(torch, cfg, dp, pm, st, cycle):
    """Dispatcher operations of one `memsys.eager_step` (the fused round
    counted as one call, whatever it runs inside) and the state after
    it: the operations a captured step records."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels.fused_tlb import ops
    from repro_torch.sim import memsys

    class Count(TorchDispatchMode):
        n, inside = 0, 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not self.inside
            return func(*args, **(kwargs or {}))

    mode, kernel = Count(), ops.fused_tlb_round

    def round_as_one(*a, **k):
        mode.n += 1
        mode.inside += 1
        try:
            return kernel(*a, **k)
        finally:
            mode.inside -= 1

    ops.fused_tlb_round = round_as_one
    try:
        with torch.inference_mode(), mode:
            st = memsys.eager_step(cfg, dp, pm, st, cycle)
    finally:
        ops.fused_tlb_round = kernel
    return mode.n, st


def grid_phase(torch, np, card, fused_tlb_round, fused_tlb_access_ref,
               single_rate):
    """Phase 12: the row-axis kernel and the grid layer on the card.
    Returns the fields it adds to the fused_tlb entry of the JSON line."""
    from repro_torch.core.design import (design_params, get_design,
                                         stack_params)
    from repro_torch.core.mask import ALL_DESIGNS
    from repro_torch.sim import memsys, runner
    from repro_torch.sim.config import SimConfig
    from repro_torch.sim.workloads import app_matrix

    # ---- kernel: rows against the plain version and against R = 1 ------
    checked = 0
    max_err = 0
    for label, shape in (("L2", L2_SHAPE), ("PWC", PWC_SHAPE)):
        for rows in GRID_ROWS_CHECKED:
            case = stack_cases(np, [path_case(np, *shape, "half",
                                              seed=1000 * rows + 17 * r)
                                    for r in range(rows)])
            max_err = max(max_err, compare(torch, fused_tlb_round,
                                           fused_tlb_access_ref, case))
            args, kw = on_card(torch, case)
            batched = fused_tlb_round(*args, case["time"], **kw)
            for r in range(rows):
                one_args, _ = on_card(torch, row_case(case, r))
                one = fused_tlb_round(*one_args, case["time"], **kw)
                for name, a, b in zip(("tags", "asids", "lru", "hit",
                                       "filled"), batched, one):
                    if not torch.equal(a[r], b):
                        raise AssertionError(
                            f"fused_tlb row {r} of {rows} != the kernel on "
                            f"that row alone: {name} ({label})")
            checked += 1
    log(f"[grid] fused_tlb with rows == plain version (max |err| "
        f"{max_err}) and each row == the kernel on that row alone, R in "
        f"{GRID_ROWS_CHECKED} at the L2 and PWC shapes [{card}]")

    # ---- rows with every lane masked off, at a grouped pass's R --------
    # the 7 non-ideal designs x 3 mixes as below: `pwc` holds rows 0-2, so
    # the PWC round runs with the other 18 rows masked off; at the L2$
    # shape, every third row off
    R21 = GRID_GROUP_ROWS
    idle_err = 0
    for label, shape, idle in (("L2", L2_SHAPE, range(0, R21, 3)),
                               ("PWC", PWC_SHAPE, range(3, R21))):
        case = stack_cases(np, [path_case(np, *shape, "half",
                                          seed=5000 + 31 * r)
                                for r in range(R21)])
        case["active"][list(idle)] = False
        idle_err = max(idle_err, compare(torch, fused_tlb_round,
                                         fused_tlb_access_ref, case))
        args, kw = on_card(torch, case)
        out = fused_tlb_round(*args, case["time"], **kw)
        for r in idle:
            for name, a in zip(("tags", "asids", "lru"), out):
                if not np.array_equal(a[r].cpu().numpy(), case[name][r]):
                    raise AssertionError(
                        f"fused_tlb changed {name} of row {r}, whose lanes "
                        f"are all masked off ({label}, R = {R21})")
            if bool(out[3][r].any()) or bool(out[4][r].any()):
                raise AssertionError(f"fused_tlb hit or filled in row {r}, "
                                     f"whose lanes are all masked off "
                                     f"({label}, R = {R21})")
    log(f"[grid] fused_tlb at R = {R21} with rows masked off (L2: 7 of "
        f"them, PWC: 18, as a mixed group's PWC round) == plain version "
        f"(max |err| {idle_err}); every masked row's tags, asids and lru as "
        f"they were, no hit or fill there [{card}]")

    times = []
    for label, shape in (("L2", L2_SHAPE), ("PWC", PWC_SHAPE)):
        for rows in (1, GRID_ROWS_TIMED):
            case = stack_cases(np, [path_case(np, *shape, "half",
                                              seed=7 + r)
                                    for r in range(rows)])
            ms = time_round_graph(torch, fused_tlb_round, case, 200)
            floor = launch_floor_graph(torch, 200)
            plain = time_round(torch, fused_tlb_access_ref, case, 20)
            args, kw = on_card(torch, case)
            out = fused_tlb_access_ref(*args, case["time"], **kw)
            least, bound_by = bound_rows(
                np, case, [t.cpu().numpy() for t in out])
            times.append(dict(round=label, rows=rows, ms=ms,
                              launch_floor_ms=floor, plain_ms=plain,
                              bound_ms=least, bound_by=bound_by))
            log(f"[grid] {label} round x {rows} rows: kernel {ms * 1e3:.2f}"
                f" us on the device (graph replay, one launch) beside a "
                f"launch floor of {floor * 1e3:.2f} us; plain version "
                f"{plain * 1e3:.2f} us; bound {least * 1e3:.4f} us by "
                f"{bound_by} [{card}]")

    # ---- the goldens through the grid: 2 passes, launches == rounds ----
    names = list(ALL_DESIGNS)
    group = [n for n in names if n != "ideal"]
    passes = []
    grid_pass = runner._grid_pass
    runner._grid_pass = lambda ccfg, ds, mixes: passes.append(
        (tuple(d.name for d in ds), len(ds) * len(mixes))) \
        or grid_pass(ccfg, ds, mixes)
    fused_tlb_round.launches = 0
    t0 = time.perf_counter()
    try:
        grid = runner.run_grid(names, GRID_MIXES, cycles=1200,
                               device="cuda")
    finally:
        runner._grid_pass = grid_pass
    grid_s = time.perf_counter() - t0
    grid_launches = fused_tlb_round.launches
    M = len(GRID_MIXES)
    if passes != [(("ideal",), M), (tuple(group), len(group) * M)]:
        raise AssertionError(f"run_grid made passes {passes}; want ideal "
                             f"alone, then the other 7 designs as one")
    # ideal: the L2$ round; the group: the L2$ round and the PWC round
    # (its pwc rows' lanes, the others masked off)
    rounds = 1200 + 1200 * 2
    for i, name in enumerate(names):
        for key, want in GOLDEN[name].items():
            got = [x.hex() for x in
                   np.asarray(grid[i][0][key], np.float64).ravel().tolist()]
            if got != want:
                raise AssertionError(f"grid {name}:{key} {got} != {want}")
    if grid_launches != rounds:
        raise AssertionError(f"run_grid launched fused_tlb {grid_launches} "
                             f"times for {rounds} rounds of 2 passes of "
                             f"{M} and {len(group) * M} rows")
    log(f"[grid] run_grid 8 designs x {M} mixes x 1200 cycles: 2 passes "
        f"({M} and {len(group) * M} rows), the 8 goldens float-hex; "
        f"fused_tlb launches {grid_launches} == rounds {rounds} (rows "
        f"share each launch); {grid_s:.1f} s [{card}]")

    # ---- grid == loop; sweep == Experiment loop; plans -----------------
    designs, mixes, cycles = GRID_LOOP
    grid = runner.run_grid(designs, mixes, cycles=cycles, device="cuda")
    for i, d in enumerate(designs):
        for m, mix in enumerate(mixes):
            loop = runner.run_mix(d, list(mix), cycles, device="cuda")
            for k in loop:
                if not np.array_equal(np.asarray(loop[k]),
                                      np.asarray(grid[i][m][k])):
                    raise AssertionError(f"grid != run_mix: {d} {mix} {k}")
    designs, mixes, cycles = SWEEP
    swept = runner.sweep(designs, mixes, cycles=cycles, device="cuda")
    for d in designs:
        ell = runner.Experiment(d, mixes, cycles, device="cuda").run()
        res = swept[d]
        if res.solo_ipc != ell.solo_ipc or len(res) != len(ell):
            raise AssertionError(f"sweep != Experiment: {d} solo baselines")
        for a, b in zip(res, ell):
            if (a.weighted_speedup() != b.weighted_speedup()
                    or a.unfairness() != b.unfairness()
                    or any(not np.array_equal(np.asarray(a.raw[k]),
                                              np.asarray(b.raw[k]))
                           for k in a.raw)):
                raise AssertionError(f"sweep != Experiment: {d} "
                                     f"{a.benches}")
    cands = [("3DS",), ("BLK",), ("3DS", "BLK")]
    plans = []
    for _ in range(2):
        before = runner.TRACE_COUNT
        pred = runner.predict_mixes("mask", cands, cycles=300, pad_rows=8,
                                    device="cuda")
        plans.append(runner.TRACE_COUNT - before)
    if plans != [1, 0] or len(pred) != 3:
        raise AssertionError(f"predict_mixes set up {plans} plans; want "
                             f"[1, 0]")
    log(f"[grid] run_grid == run_mix (bitwise), sweep == Experiment loop, "
        f"predict_mixes with pad_rows: {plans} plans; weighted speedup of "
        f"3DS+BLK {pred[2].weighted_speedup!r}")

    # ---- no host sync in a step of 8 rows ------------------------------
    cfg = SimConfig(design=get_design("mask"), sim_cycles=20, device="cuda")
    dp = design_params(cfg.design)
    pm = torch.tensor(np.stack([app_matrix(m) for m in grid_rows()[:8]]),
                      device="cuda")
    st = runner.simulate(cfg, dp, pm)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            for cycle in range(20, 25):
                st = memsys.step(cfg, dp, pm, st, cycle)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("[grid] 5 steps of 8 rows under set_sync_debug_mode('error'): no "
        "host sync")

    # ---- a mixed step: 7 designs x 3 mixes, no host sync ----------------
    gcfg = SimConfig(design=get_design("gpu-mmu"), sim_cycles=20,
                     device="cuda")
    gdp = stack_params([design_params(n) for n in group], M, "cuda")
    gpm = torch.tensor(np.stack([app_matrix(m) for _ in group
                                 for m in GRID_MIXES]), device="cuda")
    gst = runner.simulate(gcfg, gdp, gpm)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            for cycle in range(20, 25):
                gst = memsys.step(gcfg, gdp, gpm, gst, cycle)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log(f"[grid] 5 steps of a mixed group ({len(group)} designs x {M} "
        f"mixes = {gpm.shape[0]} rows, every knob per row but "
        f"initial_frac/step_frac) under set_sync_debug_mode('error'): no "
        f"host sync")

    # ---- phase 4's one-design step: the parent's operations -------------
    mcfg = SimConfig(design=get_design("mask"), sim_cycles=20,
                     device="cuda")
    mdp = design_params(mcfg.design)
    mpm = torch.tensor(app_matrix(["3DS", "BLK"]), device="cuda")[None]
    mst = runner.simulate(mcfg, mdp, mpm)
    epoch = mcfg.design.epoch_cycles
    ops = []
    for cycle in (epoch - 1, epoch):           # t = epoch_cycles: an epoch
        n, mst = step_ops(torch, mcfg, mdp, mpm, mst, cycle)
        ops.append(n)
    if tuple(ops) != PARENT_MASK_STEP_OPS:
        raise AssertionError(f"run_mix's mask step issued {ops} operations "
                             f"(epoch, between); the parent's: "
                             f"{PARENT_MASK_STEP_OPS}")
    log(f"[grid] phase 4's one-design mask step: {ops[0]} operations at an "
        f"epoch, {ops[1]} between, == the parent's "
        f"{PARENT_MASK_STEP_OPS} (fused round counted as one)")

    # ---- the 8-design grid grouped against one pass per design ---------
    dmixes = grid_rows()[:GRID_DESIGN_MIXES]
    walls = {"grouped": [], "per_design": []}
    for how in ("grouped", "per_design", "per_design", "grouped"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if how == "grouped":
            out = runner.run_grid(names, dmixes, cycles=GRID_DESIGN_CYCLES,
                                  device="cuda")
        else:
            out = [runner.run_grid([n], dmixes, cycles=GRID_DESIGN_CYCLES,
                                   device="cuda")[0] for n in names]
        walls[how].append(time.perf_counter() - t0)
        if how == "grouped" and len(walls[how]) == 1:
            first = out
        elif any(not np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
                 for ra, rb in zip(out, first) for a, b in zip(ra, rb)
                 for k in a):
            raise AssertionError(f"{how} grid != the grouped grid")
    grouped, per_design = (float(np.mean(walls[k]))
                           for k in ("grouped", "per_design"))
    log(f"[grid] 8 designs x {len(dmixes)} mixes x {GRID_DESIGN_CYCLES} "
        f"cycles: grouped (2 passes) {walls['grouped']} s, one pass per "
        f"design (8 passes) {walls['per_design']} s, in turns; mean "
        f"{per_design / grouped:.2f}x; the cells equal bitwise [{card}]")

    # ---- throughput: row-cycles per second ------------------------------
    rows_all = grid_rows()
    rates = {}
    for rows in GRID_RATE_ROWS:
        t0 = time.perf_counter()
        runner.run_batch("mask", rows_all[:rows], cycles=GRID_RATE_CYCLES,
                         device="cuda")
        dt = time.perf_counter() - t0
        rates[rows] = rows * GRID_RATE_CYCLES / dt
        log(f"[grid] mask pass of {rows} rows x {GRID_RATE_CYCLES} cycles: "
            f"{dt:.2f} s, {rates[rows]:.1f} simulated row-cycles/s "
            f"({rates[rows] / rates[1]:.2f}x R = 1; phase 4's single run: "
            f"{single_rate:.1f} cycles/s) [{card}]")
    pm = torch.tensor(np.stack([app_matrix(m) for m in rows_all]),
                      device="cuda")
    st = runner.simulate(cfg, dp, pm)
    dev_ms, kernels, wall_ms = profile_steps(torch, cfg, dp, pm, st, 20,
                                             GRID_PROFILE_STEPS)
    log(f"[grid] step of {len(rows_all)} rows ({GRID_PROFILE_STEPS} steps "
        f"in torch.profiler): {wall_ms:.2f} ms wall, {dev_ms:.3f} ms on "
        f"the device, {kernels:.0f} kernels, device busy "
        f"{dev_ms / wall_ms:.1%} [{card}]")
    r40 = [t for t in times if t["rows"] == GRID_ROWS_TIMED]
    return dict(rows_checked=list(GRID_ROWS_CHECKED), rows_timed=r40,
                grid_launches=grid_launches, grid_passes=len(passes),
                mask_step_ops=ops,
                design_grid={"designs": len(names), "mixes": len(dmixes),
                             "cycles": GRID_DESIGN_CYCLES,
                             "grouped_s": walls["grouped"],
                             "per_design_s": walls["per_design"]},
                row_cycles_per_s={str(k): v for k, v in rates.items()},
                grid_step={"rows": len(rows_all), "device_ms": dev_ms,
                           "kernels": kernels, "wall_ms": wall_ms})


CHURN_SEED, CHURN_SEGMENTS, CHURN_SLOTS, CHURN_SEG = 3, 8, 4, 250
CHURN_GOLDEN = ([("3DS", "BLK")] * 4, 300)      # 4 x 300 = mask's golden
CHURN_PWC = ([("3DS", "BLK"), ("3DS", None), ("MUM", "BLK")], 100)
TEARDOWN_BOUNDARIES = 20


def churn_plan():
    """Every fault kind and every flush level, at the seeded trace's
    boundaries (slots < 4, segments < 8)."""
    from repro_torch.sim.faults import Fault, FaultPlan
    return FaultPlan(seed=7, faults=(
        Fault("kill", 2, app=1), Fault("tlb_flush", 3, level=0),
        Fault("tlb_flush", 3, level=1), Fault("tlb_corrupt", 4, app=2),
        Fault("drop_dram", 5), Fault("walk_clobber", 6, app=3),
        Fault("tlb_flush", 7, level=2), Fault("kill", 7, app=0)))


def churn_asids(schedule, plan, n_apps):
    """The final asid_of_app a trace must end with: slot + n_apps x the
    slot's membership changes (kills included)."""
    changes = [0] * n_apps
    for k in range(1, len(schedule)):
        for s in range(n_apps):
            killed = any(f.kind == "kill" and f.segment == k and f.app == s
                         for f in plan.faults)
            changes[s] += schedule[k][s] != schedule[k - 1][s] or killed
    return [s + n_apps * c for s, c in enumerate(changes)]


def tree_leaves(tree, path="state"):
    if hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from tree_leaves(getattr(tree, f), f"{path}.{f}")
    else:
        yield path, tree


def same_trace(np, got, want, what):
    """Two TraceResults bit for bit: every snapshot, the final state."""
    from repro_torch.sim.convert import state_to_numpy
    if len(got.segments) != len(want.segments):
        raise AssertionError(f"{what}: snapshot counts differ")
    for k, (a, b) in enumerate(zip(got.segments, want.segments)):
        for key in b:
            if np.asarray(a[key]).tobytes() != np.asarray(b[key]).tobytes():
                raise AssertionError(f"{what}: snapshot {k} {key} differs")
    for (path, a), (_, b) in zip(
            tree_leaves(state_to_numpy(got.final_state)),
            tree_leaves(state_to_numpy(want.final_state))):
        if a.dtype != b.dtype or a.tobytes() != b.tobytes():
            raise AssertionError(f"{what}: final {path} differs")


def teardown_boundary(torch, cfg):
    """A boundary at full width on the card with every fault kind on (the
    upper end of a boundary's work): a callable on a state with one row."""
    from repro_torch.core.design import design_params
    from repro_torch.sim import faults
    from repro_torch.sim.memsys import apply_membership_change
    dp = design_params(cfg.design)
    i32 = dict(dtype=torch.int32, device="cuda")
    fops = faults.FaultOps(
        kill=torch.tensor([[False, True, False, False]], device="cuda"),
        flush=torch.ones((1, 3), dtype=torch.bool, device="cuda"),
        corrupt=torch.ones(1, dtype=torch.bool, device="cuda"),
        corrupt_set=torch.tensor([5], **i32),
        corrupt_way=torch.tensor([3], **i32),
        corrupt_vpn=torch.tensor([12345], **i32),
        corrupt_app=torch.tensor([2], **i32),
        drop_dram=torch.ones(1, dtype=torch.bool, device="cuda"),
        clobber=torch.ones(1, dtype=torch.bool, device="cuda"),
        clobber_row=torch.tensor([1], **i32),
        clobber_vpn=torch.tensor([999], **i32),
        clobber_app=torch.tensor([3], **i32),
        clobber_delta=torch.tensor([500], **i32))
    change = torch.tensor([[True, False, False, True]], device="cuda")

    def boundary(state):
        with torch.inference_mode():
            state = apply_membership_change(cfg, dp, state,
                                            change | fops.kill)
            return faults.apply_state_faults(cfg, state, fops)
    return boundary


def teardown_profile(torch, boundary, state, n):
    """(device ms, kernels, wall ms) per boundary over `n` boundaries in a
    `torch.profiler` window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    boundary(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            boundary(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return dev_ms / n, len(kernels) / n, wall * 1e3 / n


def churn_phase(torch, np, card, fused_tlb_round, mix_rate):
    """Phase 13: the churn runner on the card, `fused_tlb` in every cycle
    of every segment; `mix_rate` is phase 3's cycles/s of the same run as
    one `run_mix` (mask, 3DS+BLK, 1200 cycles). Returns the churn entry of
    the fused_tlb line."""
    from repro_torch.sim import memsys, runner
    from repro_torch.sim.config import SimConfig
    from repro_torch.sim.workloads import churn_schedule

    # ---- constant membership: 4 segments == the 1200-cycle golden ------
    schedule, seg = CHURN_GOLDEN
    fused_tlb_round.launches = 0
    t0 = time.perf_counter()
    tr = runner.run_trace("mask", schedule, seg_cycles=seg, device="cuda")
    golden_s = time.perf_counter() - t0
    golden_launches = fused_tlb_round.launches
    for key, want in GOLDEN["mask"].items():
        got = [x.hex() for x in
               np.asarray(tr.stats[key], np.float64).ravel().tolist()]
        if got != want:
            raise AssertionError(f"run_trace mask 4 x {seg}: {key} {got} "
                                 f"!= {want}")
    if golden_launches != len(schedule) * seg:
        raise AssertionError(f"run_trace mask launched fused_tlb "
                             f"{golden_launches} times for "
                             f"{len(schedule) * seg} rounds")
    log(f"[churn] run_trace mask 4 x {seg} == the 1200-cycle golden "
        f"float-hex; fused_tlb launches {golden_launches} == rounds; "
        f"{golden_s:.2f} s, {len(schedule) * seg / golden_s:.1f} simulated "
        f"cycles/s (the same run as one run_mix in phase 3: "
        f"{mix_rate:.1f}) [{card}]")

    # ---- seeded churn + every fault kind, audited: card == CPU ---------
    schedule = churn_schedule(seed=CHURN_SEED, n_segments=CHURN_SEGMENTS,
                              n_slots=CHURN_SLOTS)
    plan = churn_plan()
    rounds = CHURN_SEGMENTS * CHURN_SEG
    fused_tlb_round.launches = 0
    t0 = time.perf_counter()
    card_tr = runner.run_trace("mask", schedule, seg_cycles=CHURN_SEG,
                               fault_plan=plan, audit=True,
                               return_state=True, device="cuda")
    trace_s = time.perf_counter() - t0
    launches = fused_tlb_round.launches
    if launches != rounds:
        raise AssertionError(f"churn trace launched fused_tlb {launches} "
                             f"times for {rounds} rounds")
    t0 = time.perf_counter()
    cpu_tr = runner.run_trace("mask", schedule, seg_cycles=CHURN_SEG,
                              fault_plan=plan, audit=True,
                              return_state=True, device="cpu")
    cpu_s = time.perf_counter() - t0
    same_trace(np, card_tr, cpu_tr, "churn trace card vs CPU")
    asids = card_tr.final_state.asid_of_app.tolist()
    want = churn_asids(schedule, plan, CHURN_SLOTS)
    if asids != want:
        raise AssertionError(f"final asid_of_app {asids} != {want}")
    rate = rounds / trace_s
    log(f"[churn] seeded trace (churn_schedule seed {CHURN_SEED}, "
        f"{CHURN_SEGMENTS} x {CHURN_SEG} cycles, {CHURN_SLOTS} slots: "
        f"{schedule}) with every fault kind ({len(plan.faults)} faults), "
        f"audited: card == CPU (plain round) in all {CHURN_SEGMENTS} "
        f"snapshots and the final state, bit for bit; asid_of_app {asids}; "
        f"fused_tlb launches {launches} == rounds {rounds}; card "
        f"{trace_s:.2f} s, {rate:.1f} simulated cycles/s (snapshots and "
        f"audit included); CPU {cpu_s:.2f} s [{card}]")

    # ---- pwc: the PWC round after full flushes -------------------------
    schedule, seg = CHURN_PWC
    fused_tlb_round.launches = 0
    card_pwc = runner.run_trace("pwc", schedule, seg_cycles=seg,
                                return_state=True, device="cuda")
    pwc_launches = fused_tlb_round.launches
    same_trace(np, card_pwc, runner.run_trace(
        "pwc", schedule, seg_cycles=seg, return_state=True, device="cpu"),
        "pwc churn trace card vs CPU")
    if pwc_launches != 2 * len(schedule) * seg:
        raise AssertionError(f"pwc churn trace launched fused_tlb "
                             f"{pwc_launches} times for "
                             f"{2 * len(schedule) * seg} rounds")
    log(f"[churn] pwc trace {schedule} x {seg} cycles (a full PWC flush "
        f"at each boundary): card == CPU bit for bit; fused_tlb launches "
        f"{pwc_launches} == 2 rounds a cycle")

    # ---- one boundary: no host sync; its device time --------------------
    cfg = SimConfig(n_apps=CHURN_SLOTS, design="mask", device="cuda")
    boundary = teardown_boundary(torch, cfg)
    state = memsys.map_state(lambda x: x[None], card_tr.final_state)
    boundary(state)                   # sets up the config's constants
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        boundary(state)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    dev_ms, kernels, wall_ms = teardown_profile(torch, boundary, state,
                                                TEARDOWN_BOUNDARIES)
    log(f"[churn] one boundary at full width (teardown of 2 slots + a "
        f"kill, every fault kind; {TEARDOWN_BOUNDARIES} in "
        f"torch.profiler): {dev_ms:.4f} ms on the device, {kernels:.0f} "
        f"kernels, {wall_ms:.3f} ms wall; no host sync under "
        f"set_sync_debug_mode('error') [{card}]")
    return dict(launches=launches, rounds=rounds,
                golden_launches=golden_launches, pwc_launches=pwc_launches,
                cycles_per_s=rate, golden_cycles_per_s=(
                    len(CHURN_GOLDEN[0]) * CHURN_GOLDEN[1] / golden_s),
                run_mix_cycles_per_s=mix_rate,
                teardown_device_ms=dev_ms, teardown_kernels=kernels,
                teardown_wall_ms=wall_ms)


# ---- 14. the serving stack ------------------------------------------------
# benchmarks/serving_bench.py's overload run (`overload_run(seed=0)`), its
# settings copied as GOLDEN is: this script imports nothing of benchmarks/.
# `overload_run` caps the benchmark's --cycles (600) at 300 for the oracle
# (serving_bench.py:333); the reference reproduces the record at 300.
OVERLOAD_POOL = dict(n_pages=64, page_size=8, n_kv=1, head_dim=4,
                     n_layers=1, max_seqs=16, pages_per_seq=8)
OVERLOAD_TRACE = ("flood_vs_trickle", 0, 240)        # preset, seed, steps
OVERLOAD_ENGINE = dict(max_batch=8, max_running=12)
OVERLOAD_ORACLE = dict(cycles=300, slots=2, pad_rows=8)
OVERLOAD_POLICY = dict(epoch_steps=8, degrade_error=0.4, reengage_error=0.28,
                       error_window=2)
OVERLOAD_ALPHA = 0.5                                 # Recalibrator(alpha=)
OVERLOAD_DRAIN, SOLO_DRAIN = 2000, 1200
# overload_plan(0): (kind, step, duration, tenant, pages, profile)
OVERLOAD_PLAN = (("oracle_stall", 16, 8, 0, 0, "heavy"),
                 ("profile_poison", 36, 36, 0, 0, "interactive"),
                 ("pool_spike", 40, 32, 0, 64, "heavy"))
# BENCH_serving.json "overload", copied
OVERLOAD_RECORD = {
    "conservation": {"duplicated": 0, "finished": 139, "lost": 0,
                     "ok": True, "pending": 0, "submitted": 139},
    "deterministic": True,
    "overload": {
        "faults_injected": {"oracle_stall": 1, "pool_spike": 1,
                            "profile_poison": 1},
        "preempted_tenants": [0], "preemptions": 6,
        "recalibration": {
            "corrections": {"0": 1.6771178861413005,
                            "1": 1.8709685395666285},
            "last_delta": 0.09410748689521643, "rejected": 0,
            "updates": 32},
        "safe_level_final": 0,
        "safe_mode_log": [[9, 1, 0.4782721605195485],
                          [11, 0, 0.09492645630990623],
                          [15, 1, 0.4260141032294864],
                          [18, 0, 0.10599998178875163]],
        "wasted_tokens": 18},
    "plan": [["oracle_stall", 16, 8, 0], ["profile_poison", 36, 36, 0],
             ["pool_spike", 40, 32, 0]],
    "rungs": {"freeze": 2, "normal": 26, "preempt": 4, "quota": 1,
              "safe_static": 5, "stalled": 2},
    "safe_mode_engaged": True, "safe_mode_recovered": True,
    "steps": 240, "trace": "flood_vs_trickle", "unfairness": 1.57,
}
# (b): qwen3-4b at full width through the engine and the oracle
ENGINE_TRACE = ("flood_vs_trickle", 0, 32)           # preset, seed, steps
ENGINE_POOL = dict(max_seqs=16, pages_per_seq=8)     # page, KV, dh: the model's
ENGINE_CYCLES = 300                                  # make_policy("oracle", cycles=)
ENGINE_EPOCH = 8
# (c): the launcher as a user runs it
LAUNCHER = ["--arch", "qwen3-4b", "--trace", "flood_vs_trickle", "--steps",
            "24", "--policy", "oracle", "--faults", "--fault-rate", "0.1"]


def timed_oracle(**kw):
    """A `ContentionOracle` that sums the seconds of its grid calls
    (`predict_benches`; each ends in a host read of the pass's state)."""
    from repro_torch.serving.oracle import ContentionOracle

    class TimedOracle(ContentionOracle):
        seconds = 0.0

        def predict_benches(self, bench_mixes):
            t0 = time.perf_counter()
            try:
                return super().predict_benches(bench_mixes)
            finally:
                self.seconds += time.perf_counter() - t0
    return TimedOracle(**kw)


def fingerprint(eng):
    """benchmarks/serving_bench.py `_fingerprint`: the run's visible
    history (finished requests, decisions, preemptions, faults, modes)."""
    return (
        tuple((r.rid, r.tenant, r.submit_step, r.first_token_step,
               r.finish_step, r.retries, r.wasted_tokens, len(r.out))
              for r in sorted(eng.finished, key=lambda r: r.rid)),
        tuple((d.step, d.rung, d.allowed, tuple(sorted(d.caps.items())),
               tuple(sorted(d.decode_quota.items())),
               tuple(sorted(d.preempt.items())))
              for d in eng.decisions),
        tuple(eng.preempt_log),
        tuple(eng.fault_log),
        tuple(getattr(eng.placement, "mode_log", [])),
    )


def overload_phase(torch, np, card, fused_tlb_round, dev="cuda"):
    """Phase 14 (a): the reference's overload record, reproduced by the
    port's engine, placement and oracle on `dev`, stub forwards, the
    oracle's grid on the card. Returns its part of the serving entry."""
    from repro_torch.memmgr.kv_cache import PoolConfig
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import stream as strm
    from repro_torch.serving.engine import (EngineConfig, ServingEngine,
                                            stub_forwards, stub_model_config)
    from repro_torch.serving.oracle import Recalibrator
    from repro_torch.serving.placement import make_policy
    from repro_torch.sim.faults import ServingFault, ServingFaultPlan

    pool = PoolConfig(**OVERLOAD_POOL)
    name, seed, steps = OVERLOAD_TRACE
    trace = strm.make_trace(name, seed=seed, steps=steps)
    plan = ServingFaultPlan(seed=seed, faults=tuple(
        ServingFault(k, step=s, duration=d, tenant=t, pages=p, profile=pr)
        for k, s, d, t, p, pr in OVERLOAD_PLAN))

    def drive(tr, policy, solo_hint=None, fault_plan=None, drain=SOLO_DRAIN):
        eng = ServingEngine(
            stub_model_config(), None, None, pool,
            EngineConfig(**OVERLOAD_ENGINE, fault_plan=fault_plan),
            placement=policy, profiles=tr.profiles(),
            forwards=stub_forwards(), solo_hint=solo_hint, device=dev)
        strm.drive(eng, tr, drain_steps=drain)
        return eng

    t0 = time.perf_counter()
    solo = {}
    for spec in trace.specs:          # solo hints: each tenant alone, "none"
        solo.update(smet.tenant_mean_latency(
            drive(trace.only(spec.tenant), make_policy("none")).finished))
    solo_s = time.perf_counter() - t0

    runs = []
    for _ in range(2):                # the record's determinism: two builds
        oracle = timed_oracle(device=dev, **OVERLOAD_ORACLE)
        policy = make_policy("oracle", profiles=trace.profiles(),
                             oracle=oracle,
                             recalibrator=Recalibrator(alpha=OVERLOAD_ALPHA),
                             **OVERLOAD_POLICY)
        fused_tlb_round.launches = 0
        t0 = time.perf_counter()
        eng = drive(trace, policy, solo, plan, OVERLOAD_DRAIN)
        wall = time.perf_counter() - t0
        launches = fused_tlb_round.launches
        rounds = oracle.grid_calls * oracle.cycles
        if launches != rounds or launches == 0:
            raise AssertionError(f"overload: fused_tlb launched {launches} "
                                 f"times for {oracle.grid_calls} grid "
                                 f"passes x {oracle.cycles} rounds")
        runs.append((eng, oracle, wall, launches))
    eng, oracle, wall, launches = runs[0]
    over = smet.overload_summary(eng)
    modes = [lvl for _, lvl, _ in over["safe_mode_log"]]
    engaged = any(lvl > 0 for lvl in modes)
    record = {
        "trace": trace.name, "steps": trace.steps,
        "plan": [(f.kind, f.step, f.duration, f.tenant)
                 for f in plan.faults],
        "unfairness": round(smet.fairness_report(
            eng.finished, solo, eng.decisions)["unfairness"], 4),
        "conservation": smet.conservation_report(eng),
        "overload": over,
        "rungs": smet.rung_counts(eng.decisions),
        "deterministic": fingerprint(eng) == fingerprint(runs[1][0]),
        "safe_mode_engaged": engaged,
        "safe_mode_recovered": (engaged and over["safe_level_final"]
                                < max(modes)) if modes else False,
    }
    got = json.loads(json.dumps(record, sort_keys=True))
    if got != OVERLOAD_RECORD:
        diff = sorted(k for k in OVERLOAD_RECORD if got.get(k)
                      != OVERLOAD_RECORD[k])
        raise AssertionError(f"overload record differs in {diff}: "
                             f"{json.dumps({k: got.get(k) for k in diff})}")
    log(f"[serve-stack] (a) overload run (flood_vs_trickle, {steps} steps, "
        f"overload_plan(0), stub forwards, oracle {OVERLOAD_ORACLE}) == "
        f"BENCH_serving.json's overload record: "
        f"{record['conservation']['finished']}/"
        f"{record['conservation']['submitted']} finished, 0 lost, 0 "
        f"duplicated; rungs {record['rungs']}; preemptions "
        f"{over['preemptions']}, wasted tokens {over['wasted_tokens']}; "
        f"safe-mode log {over['safe_mode_log']}; corrections "
        f"{over['recalibration']['corrections']}; faults "
        f"{over['faults_injected']}; unfairness {record['unfairness']}; "
        f"two builds equal")
    log(f"[serve-stack] (a) oracle: {oracle.grid_calls} grid passes x "
        f"{oracle.cycles} cycles, fused_tlb launches {launches} == rounds "
        f"(both builds: {[r[3] for r in runs]}); {oracle.seconds:.2f} s of "
        f"the drive's {wall:.2f} s wall ({oracle.seconds / wall:.1%}); "
        f"{eng.step_count} engine steps, {eng.step_count / wall:.1f} "
        f"steps/s; solo hints {solo_s:.2f} s [{card}]")
    return dict(overload_launches=launches,
                overload_grid_calls=oracle.grid_calls,
                overload_cycles=oracle.cycles,
                overload_wall_s=wall, overload_oracle_s=oracle.seconds,
                overload_steps=eng.step_count)


def engine_phase(torch, np, card, flash_attention_bhsd, fused_tlb_round,
                 dev="cuda"):
    """Phase 14 (b): full-width qwen3-4b (bf16, `pallas_flash`) served by
    the engine under the oracle policy, its grid on the card. Returns its
    part of the serving entry."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.memmgr.kv_cache import PoolConfig
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import stream as strm
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.placement import make_policy

    torch.cuda.reset_peak_memory_stats()
    model, cfg, run, params = model_setup(torch, None)
    pool = PoolConfig(n_pages=ENGINE_POOL["max_seqs"] * ENGINE_POOL[
        "pages_per_seq"], page_size=cfg.kv_page_size, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_layers=cfg.n_layers, **ENGINE_POOL)
    name, seed, steps = ENGINE_TRACE
    trace = strm.make_trace(name, seed=seed, steps=steps)
    finite_ok = torch.ones((), dtype=torch.bool, device=dev)
    prefills = []

    def prefill(cfg_, run_, params_, batch, max_len=None):
        logits, caches = model.forward_prefill(cfg_, run_, params_, batch,
                                               max_len=max_len)
        prefills.append(tuple(batch["tokens"].shape))
        finite_ok.logical_and_(torch.isfinite(logits.float()).all())
        return logits, caches

    def decode(cfg_, run_, params_, batch, caches):
        logits, caches = model.forward_decode(cfg_, run_, params_, batch,
                                              caches)
        finite_ok.logical_and_(torch.isfinite(logits.float()).all())
        return logits, caches

    oracle = timed_oracle(cycles=ENGINE_CYCLES, device=dev)
    policy = make_policy("oracle", profiles=trace.profiles(), oracle=oracle,
                         epoch_steps=ENGINE_EPOCH)
    ecfg = EngineConfig(**OVERLOAD_ENGINE)
    eng = ServingEngine(cfg, run, params, pool, ecfg, placement=policy,
                        profiles=trace.profiles(), forwards=(prefill, decode),
                        device=dev)
    torch.cuda.synchronize()
    zero_counts(flash_attention_bhsd)
    fused_tlb_round.launches = 0
    t0 = time.perf_counter()
    strm.drive(eng, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash = flash_attention_bhsd.launches
    tlb = fused_tlb_round.launches
    cons = smet.conservation_report(eng)
    if not cons["ok"] or cons["pending"]:
        raise AssertionError(f"engine conservation {cons}")
    routed(flash_attention_bhsd, "wgmma", cfg.n_layers * len(prefills),
           f"{len(prefills)} engine prefills of {cfg.n_layers} layers")
    if tlb != oracle.grid_calls * oracle.cycles or tlb == 0:
        raise AssertionError(f"engine: fused_tlb launched {tlb} times for "
                             f"{oracle.grid_calls} grid passes x "
                             f"{oracle.cycles} rounds")
    if not bool(finite_ok):
        raise AssertionError("engine: a non-finite logit")
    decoded = sum(r.decoded for r in eng.finished)
    peak = torch.cuda.max_memory_allocated()

    # the first finished request against a direct greedy run of its prompt
    req = eng.finished[0]
    tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                             device=dev)[None]
    logits, caches = model.forward_prefill(
        cfg, run, params, {"tokens": tokens},
        max_len=pool.pages_per_seq * pool.page_size)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(min(req.max_new, ecfg.decode_len_cap)):
        tok = torch.as_tensor(np.asarray([[want[-1]]], np.int32),
                              device=dev)
        logits, caches = model.forward_decode(cfg, run, params,
                                              {"tokens": tok}, caches)
        want.append(int(torch.argmax(logits[0, -1])))
    if req.out != want:
        raise AssertionError(f"request {req.rid}: engine tokens {req.out} "
                             f"!= direct greedy {want}")
    # the kernel against its plain version at each prefill shape the engine
    # gave it (after the counts were read: these launches are not the path's)
    shapes = sorted(set(prefills))
    held = []
    for B, S in shapes:
        q, k, v = flash_inputs(torch, np, S, cfg.n_heads, cfg.n_kv_heads,
                               cfg.head_dim, "bfloat16", S + B, B=B)
        err, share, _ = flash_compare(
            torch, flash_attention_bhsd, attention_ref, q, k, v, True,
            cfg.sliding_window, FLASH_TOL["bfloat16"], rounding=True,
            block_q=512, block_k=512)
        held.append((B, S, err, share))
    del q, k, v
    log(f"[serve-stack] (b) flash == plain version at the engine's "
        f"{len(shapes)} prefill shape(s) (B, S) {[h[:2] for h in held]}, "
        f"H={cfg.n_heads} KV={cfg.n_kv_heads} dh={cfg.head_dim} causal "
        f"bf16: max |err| {max(h[2] for h in held):.3g}, largest "
        f"share {max(h[3] for h in held):.3g} of the rounding bound [{card}]")
    summ = smet.decision_summary(eng.decisions)
    log(f"[serve-stack] (b) {cfg.name} at full width ({cfg.n_layers} layers, "
        f"d_model {cfg.d_model}, bf16, pallas_flash) through the engine "
        f"(oracle policy, {ENGINE_CYCLES} cycles; pool {pool.n_pages} pages "
        f"of {pool.page_size}, {pool.n_kv} KV heads of {pool.head_dim}) over "
        f"{name}(seed={seed}, steps={steps}): {cons['finished']}/"
        f"{cons['submitted']} finished, 0 lost, 0 duplicated; "
        f"{len(prefills)} prefills (re-prefills after "
        f"{eng.preemptions} preemptions included), flash launches {flash} "
        f"== {cfg.n_layers} x prefills, all wgmma; fused_tlb {tlb} == "
        f"{oracle.grid_calls} grid passes x {oracle.cycles}; every logit "
        f"finite; request {req.rid}'s {len(req.out)} tokens == a direct "
        f"greedy prefill + decode, bit for bit; rungs {summ['rungs']}")
    log(f"[serve-stack] (b) {eng.step_count} engine steps in {wall:.2f} s: "
        f"{eng.step_count / wall:.2f} steps/s, {decoded} decoded tokens, "
        f"{decoded / wall:.1f} tokens/s; oracle {oracle.seconds:.2f} s "
        f"({oracle.seconds / wall:.1%} of wall); peak memory "
        f"{peak / 2**30:.2f} GiB [{card}]")
    out = dict(engine_flash_launches=flash, engine_prefills=len(prefills),
               engine_fused_tlb_launches=tlb,
               engine_grid_calls=oracle.grid_calls,
               engine_steps_per_s=eng.step_count / wall,
               engine_tokens_per_s=decoded / wall,
               engine_oracle_share=oracle.seconds / wall,
               engine_peak_gib=peak / 2**30,
               engine_prefill_shapes=[list(h[:2]) for h in held],
               engine_max_abs_err=max(h[2] for h in held))
    del params, caches, logits, eng
    torch.cuda.empty_cache()
    return out


def launcher_phase(card, args=LAUNCHER, tag="(c)"):
    """Phase 14 (c) and (e): `python -m repro_torch.launch.serve` on the
    card, in a process of its own (it loads the libraries phase 1
    built)."""
    import os
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"launcher exited {proc.returncode}:\n"
                             f"{proc.stdout}\n{proc.stderr[-4000:]}")
    cons = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("conservation:")]
    if len(cons) != 1 or not cons[0].endswith("lost 0 duplicated 0"):
        raise AssertionError(f"launcher conservation: {cons}\n{proc.stdout}")
    for ln in proc.stdout.splitlines():
        log(f"[serve-stack] {tag} | {ln}")
    log(f"[serve-stack] {tag} python -m repro_torch.launch.serve "
        f"{' '.join(args)}: exit 0 in {wall:.1f} s [{card}]")
    return wall


# ---- 15-16 and 14 (d)-(e): the remaining model families ------------------
MOE_ARCH = "olmoe-1b-7b"
MOE_MATCH_LAYERS = 2                 # the fp32 match and int8 olmoe: depth cut
PHI_ARCH, PHI_NEW = "phi-3-vision-4.2b", 16
WHISPER_ARCH, WHISPER_PROMPT = "whisper-base", 448
MIXTRAL_ARCH, MIXTRAL_LAYERS, MIXTRAL_S, MIXTRAL_NEW = \
    "mixtral-8x22b", 2, 5120, 8
JAMBA_ARCH, JAMBA_NEW = "jamba-1.5-large-398b", 16
# one period of jamba at d_model 2048: the full period at d_model 8192 is
# ~40 B params (80 GB in bf16) and does not fit one card; heads, KV heads,
# head dim and d_ff are cut with it, experts, top-k, moe_every, attn_every,
# d_state and the SSM head dim are kept
JAMBA_CUT = dict(n_layers=8, d_model=2048, n_heads=16, n_kv_heads=2,
                 d_head=128, d_ff=6144)
INT8_B, INT8_S, INT8_STEPS = 4, 512, 8
INT8_LAW = 0.1                       # tests/test_quant.py: max|d| / std(ref)
ENGINE_MOE_TRACE = ("flood_vs_trickle", 0, 16)       # preset, seed, steps
LAUNCHERS = (["--arch", MOE_ARCH], ["--arch", WHISPER_ARCH])


class MoeProbe:
    """Wraps `repro_torch.models.moe.moe_apply`, which `lm` calls through
    the module: CUDA events around each call and each call's
    dropped_frac. The events add no launch of any kernel."""

    def __init__(self, torch):
        from repro_torch.models import moe
        self.torch, self.moe, self.orig = torch, moe, moe.moe_apply
        self.events, self.dropped = [], []

    def __enter__(self):
        torch = self.torch

        def probe(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out, aux = self.orig(*args, **kw)
            end.record()
            self.events.append((start, end))
            self.dropped.append(aux["dropped_frac"])
            return out, aux
        self.moe.moe_apply = probe
        return self

    def __exit__(self, *exc):
        self.moe.moe_apply = self.orig

    def ms(self):
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)

    def max_dropped(self):
        return float(self.torch.stack(self.dropped).max())


def cut(arch, **kw):
    import dataclasses
    from repro_torch.configs import get_model
    return dataclasses.replace(get_model(arch), **kw)


def n_attn_layers(cfg):
    return sum(1 for k in cfg.layer_kinds() if k == "attn")


def seeded(torch, np, shape, seed):
    """numpy normals on the card in bf16 (frames, patch embeddings)."""
    return torch.tensor(np.random.RandomState(seed).randn(*shape),
                        dtype=torch.float32, device="cuda").to(torch.bfloat16)


def hold_flash(torch, np, kernel, cfg, B, S, card, tag):
    """The tensor-core flash kernel against its plain version at a path's
    prefill shape (after the path's counts were read)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    q, k, v = flash_inputs(torch, np, S, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, "bfloat16", S + B, B=B)
    err, share, _ = flash_compare(
        torch, kernel, attention_ref, q, k, v, True, cfg.sliding_window,
        FLASH_TOL["bfloat16"], rounding=True, block_q=512, block_k=512)
    log(f"[{tag}] flash == plain version at the prefill's shape (B={B}, "
        f"S={S}, H={cfg.n_heads}, KV={cfg.n_kv_heads}, dh={cfg.head_dim}, "
        f"causal, window {cfg.sliding_window}, bf16): max |err| {err:.3g}, "
        f"{share:.3g} of the rounding bound [{card}]")
    del q, k, v
    torch.cuda.empty_cache()
    return err


def moe_phase(torch, np, card, flash):
    """Phase 15: olmoe-1b-7b at full width and depth in bf16 (prefill twice,
    64 decode steps, the MoE FFN's share of a prefill's device time, two
    runs of one MoE layer bit-equal), then its fp32 match at 2 layers."""
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.params import count_params, tree_map
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, cfg, run, params = model_setup(torch, None, MOE_ARCH)
    torch.cuda.synchronize()
    log(f"[moe] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_experts} experts of {cfg.expert_d_ff}, top-{cfg.top_k}, "
        f"{count_params(params) / 1e9:.3f} B params in bf16 on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    tokens = serve_tokens(torch, np, cfg)
    max_len = SERVE_S + SERVE_NEW
    zero_counts(flash)
    times = []
    for i in range(2):                       # cold, then timed and probed
        with MoeProbe(torch) as probe:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            logits, caches = model.forward_prefill(
                cfg, run, params, {"tokens": tokens}, max_len=max_len)
            end.record()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        finite(torch, logits, "moe prefill")
    launches = flash.launches
    routed(flash, "wgmma", cfg.n_layers * 2,
           f"2 {cfg.name} prefills of {cfg.n_layers} layers")
    prefill_dev = start.elapsed_time(end)
    moe_ms = probe.ms()
    if len(probe.events) != cfg.n_layers:
        raise AssertionError(f"moe_apply ran {len(probe.events)} times in a "
                             f"prefill of {cfg.n_layers} layers")
    t0 = time.perf_counter()
    for _ in range(SERVE_NEW):
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).int()
        logits, caches = model.forward_decode(cfg, run, params,
                                              {"tokens": tok}, caches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    finite(torch, logits, "moe decode")
    if caches["cache_len"].tolist() != [max_len] * SERVE_B:
        raise AssertionError(f"cache_len {caches['cache_len'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    del caches, logits
    # determinism: one MoE layer, twice, at the prefill's shape
    lp = tree_map(lambda a: a[0], params["blocks"])["layer0"]["moe"]
    x = seeded(torch, np, (SERVE_B, SERVE_S, cfg.d_model), 2)
    a, aux = moe_mod.moe_apply(lp, x, top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
    b, _ = moe_mod.moe_apply(lp, x, top_k=cfg.top_k,
                             capacity_factor=cfg.capacity_factor)
    if not torch.equal(a.view(torch.int16), b.view(torch.int16)):
        raise AssertionError("two runs of one MoE layer differ")
    dropped = float(aux["dropped_frac"])
    del params, a, b, x
    torch.cuda.empty_cache()
    log(f"[moe] prefill {SERVE_B} x {SERVE_S} tokens: {times[0] * 1e3:.1f} ms "
        f"cold, {times[1] * 1e3:.1f} ms warm ({prefill_dev:.1f} ms between "
        f"CUDA events; the {cfg.n_layers} MoE FFNs {moe_ms:.1f} ms of it, "
        f"{moe_ms / prefill_dev:.1%}); decode {SERVE_NEW} steps at B="
        f"{SERVE_B} (one routing group): {decode_s * 1e3 / SERVE_NEW:.2f} ms "
        f"per step, {SERVE_B * SERVE_NEW / decode_s:.1f} tokens/s; peak "
        f"memory {peak / 2**30:.2f} GiB; flash launches {launches} == "
        f"{cfg.n_layers} x 2 prefills, all wgmma; two runs of one MoE layer "
        f"at ({SERVE_B}, {SERVE_S}) bit-equal (dropped_frac {dropped:.4f} "
        f"at capacity_factor {cfg.capacity_factor}) [{card}]")
    err = hold_flash(torch, np, flash, cfg, SERVE_B, SERVE_S, card, "moe")
    # fp32 match at 2 layers, no token dropped
    mcfg = cut(MOE_ARCH, n_layers=MOE_MATCH_LAYERS,
               capacity_factor=float(cfg.n_experts))
    zero_counts(flash)
    with MoeProbe(torch) as probe:
        match_phase(torch, np, card, tag="moe-match", cfg=mcfg)
    routed(flash, "split_tf32", MOE_MATCH_LAYERS * 2,
           f"fp32 forward_train + forward_prefill of {MOE_MATCH_LAYERS} "
           f"layers")
    if probe.max_dropped() != 0.0:
        raise AssertionError(f"moe-match: dropped_frac "
                             f"{probe.max_dropped()} at capacity_factor "
                             f"{mcfg.capacity_factor}")
    log(f"[moe-match] {MOE_MATCH_LAYERS} layers, capacity_factor "
        f"{mcfg.capacity_factor:g}: dropped_frac 0 in all "
        f"{len(probe.dropped)} MoE calls; flash {MOE_MATCH_LAYERS * 2} "
        f"launches, all split_tf32")
    return dict(arch=cfg.name, launches=launches,
                per_prefill=cfg.n_layers, prefill_ms=times[1] * 1e3,
                prefill_device_ms=prefill_dev, moe_ms=moe_ms,
                moe_share=moe_ms / prefill_dev,
                decode_ms_per_step=decode_s * 1e3 / SERVE_NEW,
                decode_tokens_per_s=SERVE_B * SERVE_NEW / decode_s,
                peak_gib=peak / 2**30, max_abs_err=err,
                match_split_tf32_launches=MOE_MATCH_LAYERS * 2)


def family_run(torch, np, card, flash, ssd, cfg, B, S, steps, tag,
               extra=None, n_ssd=0):
    """One family at full width (or cut in depth) in bf16: one prefill of
    B prompts (`extra`: frames or patch embeddings ahead of S - patches
    tokens), `steps` greedy decode steps; flash (and ssd) launches per
    prefill counted. Returns its entry."""
    from repro_torch.models.params import count_params
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, cfg, run, params = model_setup(torch, None, cfg=cfg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.RandomState(0)
    n_text = S - cfg.n_patches
    batch = {"tokens": torch.tensor(
        rng.randint(0, cfg.vocab_size, (B, n_text)), dtype=torch.int32,
        device="cuda")}
    batch.update(extra or {})
    max_len = S + steps
    zero_counts(flash)
    ssd.launches = 0
    t0 = time.perf_counter()
    logits, caches = model.forward_prefill(cfg, run, params, batch,
                                           max_len=max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    launches, ssd_launches = flash.launches, ssd.launches
    n_attn = n_attn_layers(cfg)
    routed(flash, "wgmma", n_attn, f"a {cfg.name} prefill of {n_attn} "
           f"attention layers")
    if ssd_launches != n_ssd:
        raise AssertionError(f"{cfg.name}: ssd_intra_chunk launched "
                             f"{ssd_launches} times, want {n_ssd}")
    finite(torch, logits, f"{cfg.name} prefill")
    t0 = time.perf_counter()
    for _ in range(steps):
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).int()
        logits, caches = model.forward_decode(cfg, run, params,
                                              {"tokens": tok}, caches)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    finite(torch, logits, f"{cfg.name} decode")
    if caches["cache_len"].tolist() != [max_len] * B:
        raise AssertionError(f"cache_len {caches['cache_len'].tolist()}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{count_params(params) / 1e9:.3f} B params in bf16 ({setup_s:.1f} s "
        f"to make); prefill of {B} x {S} rows ({', '.join(sorted(batch))}) "
        f"{prefill_s * 1e3:.1f} ms (one call); {steps} decode steps "
        f"{decode_s * 1e3 / steps:.2f} ms per step; flash launches "
        f"{launches} (all wgmma), ssd launches {ssd_launches}; finite "
        f"logits; peak memory {peak / 2**30:.2f} GiB [{card}]")
    del params, caches, logits, batch
    torch.cuda.empty_cache()
    err = hold_flash(torch, np, flash, cfg, B, S, card, tag)
    return dict(arch=cfg.name, layers=cfg.n_layers, launches=launches,
                ssd_launches=ssd_launches, B=B, S=S,
                prefill_ms=prefill_s * 1e3,
                decode_ms_per_step=decode_s * 1e3 / steps,
                peak_gib=peak / 2**30, max_abs_err=err)


def families_phase(torch, np, card, flash, ssd):
    """Phase 16: phi-3-vision, whisper-base, mixtral (2 layers, a prompt
    past its window; its fp32 match within the window), jamba (one period
    at d_model 2048), each freed before the next."""
    from repro_torch.configs import get_model
    out = {}
    phi = get_model(PHI_ARCH)
    out["phi"] = family_run(
        torch, np, card, flash, ssd, phi, SERVE_B, SERVE_S, PHI_NEW,
        "families", extra={"patch_embeds": seeded(
            torch, np, (SERVE_B, phi.n_patches, phi.d_model), 3)})
    wh = get_model(WHISPER_ARCH)
    out["whisper"] = family_run(
        torch, np, card, flash, ssd, wh, SERVE_B, WHISPER_PROMPT, SERVE_NEW,
        "families", extra={"frames": seeded(
            torch, np, (SERVE_B, wh.enc_len, wh.d_model), 4)})
    mx = cut(MIXTRAL_ARCH, n_layers=MIXTRAL_LAYERS)
    out["mixtral"] = family_run(torch, np, card, flash, ssd, mx, 1,
                                MIXTRAL_S, MIXTRAL_NEW, "families")
    zero_counts(flash)
    with MoeProbe(torch) as probe:
        match_phase(torch, np, card, tag="families-match", cfg=cut(
            MIXTRAL_ARCH, n_layers=MIXTRAL_LAYERS,
            capacity_factor=float(mx.n_experts)))
    routed(flash, "split_tf32", MIXTRAL_LAYERS * 2,
           f"fp32 forward_train + forward_prefill of {MIXTRAL_LAYERS} layers")
    if probe.max_dropped() != 0.0:
        raise AssertionError("families-match: a token was dropped")
    jb = cut(JAMBA_ARCH, **JAMBA_CUT)
    n_ssm = jb.n_layers - n_attn_layers(jb)
    out["jamba"] = family_run(torch, np, card, flash, ssd, jb, SERVE_B,
                              SERVE_S, JAMBA_NEW, "families", n_ssd=n_ssm)
    return out


def int8_phase(torch, np, card, flash):
    """Phase 16, int8: qwen3-4b at full width and olmoe at 2 layers with
    `quantize_weights`: one decode step against bf16's under the
    reference's law, and the decode step's time in both."""
    import dataclasses
    from repro_torch.models.quant import quantize_arrays
    out = {}
    for arch, cfg in ((SERVE_ARCH, None),
                      (MOE_ARCH, cut(MOE_ARCH, n_layers=MOE_MATCH_LAYERS))):
        model, cfg, run, params = model_setup(torch, None, arch, cfg)
        tokens = torch.tensor(np.random.RandomState(5).randint(
            0, cfg.vocab_size, (INT8_B, INT8_S)), dtype=torch.int32,
            device="cuda")
        logits, caches = model.forward_prefill(
            cfg, run, params, {"tokens": tokens},
            max_len=INT8_S + INT8_STEPS + 1)
        tok = logits[:, -1].argmax(dim=-1, keepdim=True).int()

        def steps(run_, params_):
            c = {k: v.clone() for k, v in caches.items()}
            first, c = model.forward_decode(cfg, run_, params_,
                                            {"tokens": tok}, c)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(INT8_STEPS):
                lg, c = model.forward_decode(cfg, run_, params_,
                                             {"tokens": tok}, c)
            torch.cuda.synchronize()
            return first, (time.perf_counter() - t0) * 1e3 / INT8_STEPS
        ref, bf16_ms = steps(run, params)
        qparams = dict(params, blocks=quantize_arrays(params["blocks"]))
        del params
        torch.cuda.empty_cache()
        got, int8_ms = steps(dataclasses.replace(run, quantize_weights=True),
                             qparams)
        finite(torch, got, f"{cfg.name} int8 decode")
        rel = float((got.float() - ref.float()).abs().max()
                    / ref.float().std().clamp_min(1e-6))
        log(f"[int8] {cfg.name} ({cfg.n_layers} layers): a decode step after "
            f"a {INT8_B} x {INT8_S} prefill, int8 weights vs bf16: max|d| / "
            f"std(bf16) {rel:.4f} (law < {INT8_LAW}); decode step "
            f"{int8_ms:.2f} ms int8 (dequantized per block), {bf16_ms:.2f} "
            f"ms bf16 [{card}]")
        if not rel < INT8_LAW:
            raise AssertionError(f"{cfg.name}: int8 decode departs from bf16 "
                                 f"by {rel:.4f} of std")
        out[cfg.name] = dict(layers=cfg.n_layers, law=rel, int8_ms=int8_ms,
                             bf16_ms=bf16_ms)
        del qparams, caches, logits, ref, got
        torch.cuda.empty_cache()
    return out


def engine_moe_phase(torch, np, card, flash, dev="cuda"):
    """Phase 14 (d): full-width olmoe-1b-7b (bf16, `pallas_flash`) served
    by the engine under the `none` policy; the pool at its KV widths."""
    from repro_torch.memmgr.kv_cache import PoolConfig
    from repro_torch.serving import metrics as smet
    from repro_torch.serving import stream as strm
    from repro_torch.serving.engine import EngineConfig, ServingEngine
    from repro_torch.serving.placement import make_policy

    torch.cuda.reset_peak_memory_stats()
    model, cfg, run, params = model_setup(torch, None, MOE_ARCH)
    pool = PoolConfig(n_pages=ENGINE_POOL["max_seqs"] * ENGINE_POOL[
        "pages_per_seq"], page_size=cfg.kv_page_size, n_kv=cfg.n_kv_heads,
        head_dim=cfg.head_dim, n_layers=cfg.n_layers, **ENGINE_POOL)
    name, seed, steps = ENGINE_MOE_TRACE
    trace = strm.make_trace(name, seed=seed, steps=steps)
    finite_ok = torch.ones((), dtype=torch.bool, device=dev)
    prefills = []

    def prefill(cfg_, run_, params_, batch, max_len=None):
        logits, caches = model.forward_prefill(cfg_, run_, params_, batch,
                                               max_len=max_len)
        prefills.append(tuple(batch["tokens"].shape))
        finite_ok.logical_and_(torch.isfinite(logits.float()).all())
        return logits, caches

    def decode(cfg_, run_, params_, batch, caches):
        logits, caches = model.forward_decode(cfg_, run_, params_, batch,
                                              caches)
        finite_ok.logical_and_(torch.isfinite(logits.float()).all())
        return logits, caches

    ecfg = EngineConfig(**OVERLOAD_ENGINE)
    eng = ServingEngine(cfg, run, params, pool, ecfg,
                        placement=make_policy("none",
                                              profiles=trace.profiles()),
                        profiles=trace.profiles(), forwards=(prefill, decode),
                        device=dev)
    torch.cuda.synchronize()
    zero_counts(flash)
    t0 = time.perf_counter()
    strm.drive(eng, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash.launches
    eng_steps = eng.step_count
    cons = smet.conservation_report(eng)
    if not cons["ok"] or cons["pending"]:
        raise AssertionError(f"moe engine conservation {cons}")
    routed(flash, "wgmma", cfg.n_layers * len(prefills),
           f"{len(prefills)} engine prefills of {cfg.n_layers} layers")
    if not bool(finite_ok):
        raise AssertionError("moe engine: a non-finite logit")
    decoded = sum(r.decoded for r in eng.finished)
    peak = torch.cuda.max_memory_allocated()
    req = eng.finished[0]
    tokens = torch.as_tensor(np.asarray(req.prompt, np.int32),
                             device=dev)[None]
    logits, caches = model.forward_prefill(
        cfg, run, params, {"tokens": tokens},
        max_len=pool.pages_per_seq * pool.page_size)
    want = [int(torch.argmax(logits[0, -1]))]
    for _ in range(min(req.max_new, ecfg.decode_len_cap)):
        tok = torch.as_tensor(np.asarray([[want[-1]]], np.int32),
                              device=dev)
        logits, caches = model.forward_decode(cfg, run, params,
                                              {"tokens": tok}, caches)
        want.append(int(torch.argmax(logits[0, -1])))
    if req.out != want:
        raise AssertionError(f"moe request {req.rid}: engine tokens "
                             f"{req.out} != direct greedy {want}")
    del params, caches, logits, eng
    torch.cuda.empty_cache()
    shapes = sorted(set(prefills))
    err = max(hold_flash(torch, np, flash, cfg, B, S, card, "serve-stack")
              for B, S in shapes)
    log(f"[serve-stack] (d) {cfg.name} at full width ({cfg.n_layers} "
        f"layers, bf16, pallas_flash) through the engine (policy none; pool "
        f"{pool.n_pages} pages of {pool.page_size}, {pool.n_kv} KV heads of "
        f"{pool.head_dim}) over {name}(seed={seed}, steps={steps}): "
        f"{cons['finished']}/{cons['submitted']} finished, 0 lost, 0 "
        f"duplicated; {len(prefills)} prefills, flash launches {launches} == "
        f"{cfg.n_layers} x prefills, all wgmma; every logit finite; request "
        f"{req.rid}'s {len(req.out)} tokens == a direct greedy prefill + "
        f"decode, bit for bit; {eng_steps} engine "
        f"steps in {wall:.2f} s, {decoded} decoded tokens, "
        f"{decoded / wall:.1f} tokens/s; peak memory {peak / 2**30:.2f} GiB "
        f"[{card}]")
    return dict(engine_moe_launches=launches,
                engine_moe_prefills=len(prefills),
                engine_moe_tokens_per_s=decoded / wall,
                engine_moe_wall_s=wall, engine_moe_max_abs_err=err,
                engine_moe_prefill_shapes=[list(s) for s in shapes])


# ---- 17. training ----------------------------------------------------------
TRAIN_ARCH = "mamba2-1.3b"
# train_4k's global batch of 256 (a 16-way data axis) cut to 16 for one card;
# its sequence length and microbatches (8 of 2) as the registry gives them
TRAIN_B, TRAIN_STEPS = 16, 3
TRAIN_PARITY = ("qwen3-4b", "mamba2-1.3b", "olmoe-1b-7b")
TRAIN_PARITY_B, TRAIN_PARITY_S = 4, 64
TRAIN_LOSS_TOL = 1e-5      # relative, card vs CPU (fp32, TF32 off)
TRAIN_GRAD_TOL = 1e-4      # x each leaf's max |g|, card vs CPU
SSD_GRAD_TOL = 1e-5        # x each input's max |g|: Function vs plain
TRAIN_LAUNCHER = ["--arch", "qwen3-4b", "--smoke"]
TRAIN_DROP = 0.1           # tests/test_train_ckpt_ft.py::test_loss_decreases
TRAIN_DETERMINISTIC = """
import sys
import torch
torch.use_deterministic_algorithms(True)
from repro_torch.launch import train
for argv in %r:
    sys.argv = ["train"] + argv
    print("RUN " + " ".join(argv), flush=True)
    train.main()
"""


def ssd_grad_phase(torch, card):
    """Phase 17 (a): the gradients of `ops.ssd_intra_chunk` on the card
    (the kernel inside its autograd Function) against autograd through
    the plain version, at the serving shape."""
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    sv = SSD_SERVE
    B_, S, nh, hd, ds, Q = (sv[k] for k in ("B", "S", "nh", "hd", "ds", "Q"))
    gen = torch.Generator(device="cuda").manual_seed(9)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, B, C = draw(B_, S, nh, hd) * .5, draw(B_, S, ds) * .5, \
        draw(B_, S, ds) * .5
    dt = torch.rand((B_, S, nh), generator=gen, device="cuda") * .1 + .02
    A = -(torch.rand((nh,), generator=gen, device="cuda") * .5 + .1)
    args = ops.chunk_inputs(x, dt, A, B, C, Q)
    cot = [draw(*o.shape) for o in ssd_intra_chunk_ref(*args)]

    def grads(fn):
        ins = [a.detach().requires_grad_() for a in args]
        outs = fn(*ins)
        return outs, torch.autograd.grad(outs, ins, cot)

    before = ssd_intra_chunk.launches
    outs, got = grads(ops.ssd_intra_chunk)
    if ssd_intra_chunk.launches != before + 1 or not all(
            "SsdIntraChunk" in type(o.grad_fn).__name__ for o in outs):
        raise AssertionError("ops.ssd_intra_chunk on the card did not run "
                             "the kernel inside SsdIntraChunk")
    _, want = grads(ssd_intra_chunk_ref)
    err, share = 0.0, 0.0
    for name, g, w in zip(("x", "dA", "B", "C"), got, want):
        d = float((g - w).abs().max())
        scale = float(w.abs().max())
        err, share = max(err, d), max(share, d / (SSD_GRAD_TOL * scale))
        if not bool(torch.isfinite(g).all()) or d > SSD_GRAD_TOL * scale:
            raise AssertionError(f"ssd Function's d{name} != autograd "
                                 f"through the plain version: max |err| "
                                 f"{d:.3g}, max |g| {scale:.3g}")
    ms = time_events(torch, lambda: grads(ops.ssd_intra_chunk), 5, 1)
    plain_ms = time_events(torch, lambda: grads(ssd_intra_chunk_ref), 5, 1)
    torch.cuda.synchronize()
    log(f"[train] (a) ssd Function at B={B_} S={S} nh={nh} hd={hd} ds={ds} "
        f"Q={Q}: gradients of x, dA, B, C == autograd through the plain "
        f"version (max |err| {err:.3g}, {share:.3g} of {SSD_GRAD_TOL} x max "
        f"|g|); forward + backward {ms:.3f} ms (kernel forward, plain "
        f"backward) against {plain_ms:.3f} ms all plain [{card}]")
    del x, B, C, dt, args, cot, outs, got, want
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, tol_share=share, ms=ms, plain_ms=plain_ms,
                shape=dict(sv, dtype="float32"))


def train_grad_phase(torch, np, card):
    """Phase 17 (b): one `build_loss_fn` gradient of reduced fp32
    qwen3-4b, mamba2 and olmoe on the card against the port on the CPU
    from the same params (remat on); `flash_attention` refuses it."""
    import dataclasses
    from repro_torch.configs import get_model, reduced_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.models import model
    from repro_torch.models.params import subtree, tree_items, tree_map
    from repro_torch.train import step
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch in TRAIN_PARITY:
        cfg = reduced_model(get_model(arch))
        if cfg.is_moe:
            cfg = dataclasses.replace(cfg,
                                      capacity_factor=float(cfg.n_experts))
        shape = ShapeConfig("t", TRAIN_PARITY_S, TRAIN_PARITY_B, "train")
        run = RunConfig(model=cfg, shape=shape, remat=True, attn_block_q=16,
                        attn_block_k=16)
        params = model.init_params(torch.Generator().manual_seed(0), cfg,
                                   device="cpu", dtype_override=torch.float32)
        rng = np.random.RandomState(3)
        batch = {k: torch.tensor(rng.randint(0, cfg.vocab_size, (
            TRAIN_PARITY_B, TRAIN_PARITY_S)), dtype=torch.int32)
            for k in ("tokens", "labels")}
        grad_fn = step.value_and_grad(step.build_loss_fn(cfg, run))
        (want_loss, _), want = grad_fn(params, batch)
        ssd_intra_chunk.launches = 0
        (loss, _), got = grad_fn(tree_map(lambda t: t.cuda(), params),
                                 {k: v.cuda() for k, v in batch.items()})
        torch.cuda.synchronize()
        launches = ssd_intra_chunk.launches
        want_launches = 2 * cfg.n_layers if cfg.family == "ssm" else 0
        if launches != want_launches:
            raise AssertionError(f"{arch}: {launches} ssd launches, want "
                                 f"{want_launches} (forward + recompute)")
        rel = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
        worst = 0.0
        for path, w in tree_items(want):
            scale = max(float(w.abs().max()), 1e-30)
            worst = max(worst, float((subtree(got, path).cpu() - w).abs()
                                     .max()) / scale)
        log(f"[train] (b) reduced {arch} fp32 ({cfg.n_layers} layers, B="
            f"{TRAIN_PARITY_B}, S={TRAIN_PARITY_S}, remat): loss on the card "
            f"{float(loss):.6f} vs CPU {float(want_loss):.6f} (rel "
            f"{rel:.3g}, tol {TRAIN_LOSS_TOL}); worst grad leaf {worst:.3g} "
            f"of its max |g| (tol {TRAIN_GRAD_TOL}); ssd launches "
            f"{launches} [{card}]")
        if not (rel <= TRAIN_LOSS_TOL and worst <= TRAIN_GRAD_TOL):
            raise AssertionError(f"{arch}: the card's loss or grads depart "
                                 "from the CPU's")
        out[arch] = dict(loss_rel=rel, grad_rel=worst, ssd_launches=launches)
        if arch == "qwen3-4b":
            flash_run = dataclasses.replace(run, attention_impl="pallas_flash")
            try:
                step.value_and_grad(step.build_loss_fn(cfg, flash_run))(
                    tree_map(lambda t: t.cuda(), params),
                    {k: v.cuda() for k, v in batch.items()})
            except NotImplementedError:
                log("[train] (b) pallas_flash under a gradient: "
                    "NotImplementedError, as the reference")
            else:
                raise AssertionError("flash_attention took a gradient")
    return out


def train_run_config():
    """train_4k's run config for TRAIN_ARCH (remat, its microbatches), the
    global batch cut to TRAIN_B."""
    import dataclasses
    from repro_torch.configs import get_run_config
    run = get_run_config(TRAIN_ARCH, "train_4k")
    return dataclasses.replace(run, shape=dataclasses.replace(
        run.shape, global_batch=TRAIN_B))


def train_phase(torch, np, card):
    """Phase 17 (c): full-width mamba2-1.3b, bf16 params, AdamW with fp32
    moments, remat, TRAIN_STEPS steps of train_4k's run config with its
    batch cut to TRAIN_B, through `build_train_step`; the ssd launches
    counted over the steps."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.models import lm, model
    from repro_torch.models.params import count_params, tree_leaves
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.step import build_train_step
    torch.cuda.reset_peak_memory_stats()
    run = train_run_config()
    cfg, seq, micro = run.model, run.shape.seq_len, run.microbatches
    t0 = time.perf_counter()
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0),
                               cfg, device="cuda")
    opt_cfg = opt_mod.OptConfig()
    state = opt_mod.init(params, opt_cfg)
    train_step = build_train_step(cfg, run, opt_cfg)
    torch.cuda.synchronize()
    log(f"[train] (c) {cfg.name}: {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {count_params(params) / 1e9:.3f} B params in bf16, "
        f"AdamW fp32 moments, on the card in {time.perf_counter() - t0:.2f} "
        f"s")
    rng = np.random.RandomState(17)
    batches = [{k: torch.tensor(rng.randint(0, cfg.vocab_size, (
        TRAIN_B, seq)), dtype=torch.int32, device="cuda")
        for k in ("tokens", "labels")} for _ in range(TRAIN_STEPS)]
    ssd_intra_chunk.launches = 0
    secs, losses, norms = [], [], []
    for batch in batches:
        t0 = time.perf_counter()
        params, state, metrics = train_step(params, state, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    launches = ssd_intra_chunk.launches
    R = cfg.n_layers
    G = lm._scan_group(R)
    # per microbatch: the forward, the recompute of each group up to its
    # last block (the block boundaries), then each block's own recompute
    per_micro = R + (R - R // G) + R
    if launches != per_micro * micro * TRAIN_STEPS:
        raise AssertionError(f"ssd launches {launches} != {per_micro} x "
                             f"{micro} microbatches x {TRAIN_STEPS} steps")
    if not all(np.isfinite(losses + norms)) or min(norms) <= 0:
        raise AssertionError(f"losses {losses}, grad norms {norms}")
    if not all(bool(torch.isfinite(p).all()) for p in tree_leaves(params)):
        raise AssertionError("non-finite params after the steps")
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_B * seq
    warm = secs[1:] or secs
    tps = tokens * len(warm) / sum(warm)
    log(f"[train] (c) {TRAIN_STEPS} steps of {TRAIN_B} x {seq} tokens "
        f"({micro} microbatches of {TRAIN_B // micro}): loss "
        f"{', '.join(f'{v:.4f}' for v in losses)}; grad norm "
        f"{', '.join(f'{v:.4f}' for v in norms)}; s per step "
        f"{', '.join(f'{v:.2f}' for v in secs)} (first cold); {tps:.0f} "
        f"tokens/s after the first; ssd launches {launches} == {per_micro} "
        f"({R} forward + {R - R // G} group recompute + {R} block "
        f"recompute; groups of {G}) x {micro} x {TRAIN_STEPS}; peak "
        f"memory {peak / 2**30:.2f} GiB [{card}]")
    del params, state, batches
    torch.cuda.empty_cache()
    return dict(arch=TRAIN_ARCH, layers=R, batch=TRAIN_B, seq=seq,
                microbatches=micro, steps=TRAIN_STEPS, losses=losses,
                grad_norms=norms, s_per_step=secs, tokens_per_s=tps,
                peak_bytes=peak, ssd_launches=launches,
                ssd_per_microbatch=per_micro)


def train_launcher_phase(card):
    """Phase 17 (d): `python -m repro_torch.launch.train` on the card in a
    deterministic process (CUBLAS_WORKSPACE_CONFIG, deterministic
    algorithms): reduced qwen3-4b 10 steps, resumed to 14, against an
    unbroken 14, the two step-14 checkpoints bit-equal; then 30 steps with
    the loss falling by more than TRAIN_DROP."""
    import os
    import tempfile
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        a, d = os.path.join(tmp, "a"), os.path.join(tmp, "d")
        runs = [TRAIN_LAUNCHER + ["--steps", "10", "--ckpt-dir", a],
                TRAIN_LAUNCHER + ["--steps", "14", "--ckpt-dir", a],
                TRAIN_LAUNCHER + ["--steps", "14", "--ckpt-dir", d],
                TRAIN_LAUNCHER + ["--steps", "30"]]
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src")] + [p for p in [
                           os.environ.get("PYTHONPATH")] if p]))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", TRAIN_DETERMINISTIC % (runs,)], cwd=ROOT,
            env=env, capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"train launcher exited {proc.returncode}:"
                                 f"\n{proc.stdout}\n{proc.stderr[-4000:]}")
        for ln in proc.stdout.splitlines():
            log(f"[train] (d) | {ln}")
        name = os.path.join("step_000000014", "shard_0.npz")
        with np.load(os.path.join(a, name)) as fa, \
                np.load(os.path.join(d, name)) as fd:
            if sorted(fa.files) != sorted(fd.files):
                raise AssertionError("resumed and unbroken checkpoints hold "
                                     "other leaves")
            differ = [k for k in fa.files
                      if not np.array_equal(fa[k], fd[k])]
            n_leaves = len(fa.files)
        if differ:
            raise AssertionError(f"resumed run != unbroken run at step 14: "
                                 f"{differ[:5]}")
    last = [ln for ln in proc.stdout.splitlines()
            if ln.startswith("first loss")][-1].split()
    first, final = float(last[2]), float(last[5])
    if not final < first - TRAIN_DROP:
        raise AssertionError(f"30 steps: loss {first} -> {final}")
    log(f"[train] (d) launcher, deterministic: 10 steps + resume to 14 == "
        f"unbroken 14 bit for bit ({n_leaves} leaves); 30 steps: loss "
        f"{first:.4f} -> {final:.4f}; {wall:.1f} s in one process [{card}]")
    return dict(wall_s=wall, restart_leaves=n_leaves, first_loss=first,
                last_loss=final)


# ---- phase 18: the distributed layer ----------------------------------------

DIST_DESIGNS = ("mask", "gpu-mmu")
DIST_MIXES = [("3DS", "BLK"), ("MUM", "RED"), ("3DS", "MUM")]
DIST_CYCLES = 120          # tests/test_sharded_grid.py's sweep
DIST_SHARDS = 4
DIST_TRAIN_B = 2           # one microbatch of train_4k's 2 x 4096


def sharded_grid_phase(torch, np, card, fused_tlb_round, dev="cuda"):
    """Phase 18 (a): a sweep's rows sharded over DIST_SHARDS devices, all
    of them `dev` (`runner._shard_devices` patched: one card), against
    the same sweep on one device, float-hex; fused_tlb launches == the
    shards' rounds; unpatched, devices=2 on one card raises."""
    from repro_torch.sim import runner
    kw = dict(cycles=DIST_CYCLES, solo_baselines=True, grid=True, device=dev)
    single = runner.sweep(list(DIST_DESIGNS), DIST_MIXES, **kw)
    shard_devices, run_rows = runner._shard_devices, runner._run_rows
    shards = []

    def counted(cfg, dp, mixes):
        shards.append((cfg.device, len(mixes)))
        return run_rows(cfg, dp, mixes)

    runner._shard_devices = lambda device, n: [torch.device(dev)] * n
    runner._run_rows = counted
    fused_tlb_round.launches = 0
    t0 = time.perf_counter()
    try:
        sharded = runner.sweep(list(DIST_DESIGNS), DIST_MIXES,
                               devices=DIST_SHARDS, **kw)
    finally:
        runner._shard_devices, runner._run_rows = shard_devices, run_rows
    secs = time.perf_counter() - t0
    launches = fused_tlb_round.launches
    rounds = len(shards) * DIST_CYCLES      # one fused round a cycle
    if launches != rounds or len(shards) % DIST_SHARDS:
        raise AssertionError(f"fused_tlb launched {launches} times for "
                             f"{len(shards)} shards x {DIST_CYCLES} rounds")
    stats = 0
    for name in DIST_DESIGNS:
        a, b = single[name], sharded[name]
        if len(a) != len(b) or a.solo_ipc != b.solo_ipc:
            raise AssertionError(f"{name}: sharded sweep's solo baselines "
                                 "differ")
        for xa, xb in zip(a, b):
            for k in xa.raw:
                ha = [float(v).hex() for v in np.atleast_1d(xa.raw[k]).ravel()]
                hb = [float(v).hex() for v in np.atleast_1d(xb.raw[k]).ravel()]
                if ha != hb:
                    raise AssertionError(f"{name}:{k} sharded {hb} != {ha}")
                stats += len(ha)
    visible = torch.cuda.device_count() if dev == "cuda" else 1
    refusal = f"not checked: {visible} devices visible"
    if visible < 2:
        try:
            runner.run_grid(list(DIST_DESIGNS), DIST_MIXES,
                            cycles=DIST_CYCLES, devices=2, device=dev)
        except ValueError as e:
            if "devices=2" not in str(e):
                raise AssertionError(f"devices=2 raised {e!r}") from e
            refusal = str(e)
        else:
            raise AssertionError("run_grid(devices=2) ran on one device")
    log(f"[dist] (a) sweep of {len(DIST_DESIGNS)} designs x "
        f"{len(DIST_MIXES)} mixes at {DIST_CYCLES} cycles with solo "
        f"baselines, rows over {DIST_SHARDS} shards on {dev} (shards of "
        f"{sorted({n for _, n in shards})} rows): {stats} stats == the "
        f"unsharded sweep float-hex; fused_tlb launches {launches} == "
        f"{len(shards)} shards x {DIST_CYCLES} rounds; {secs:.2f} s; "
        f"unpatched: {refusal!r} [{card}]")
    return dict(designs=list(DIST_DESIGNS), mixes=len(DIST_MIXES),
                cycles=DIST_CYCLES, shards=len(shards),
                rows_per_shard=sorted({n for _, n in shards}),
                launches=launches, stats_equal=stats, s=secs)


def _host_tree(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.models.params import tree_items
    return {"/".join(path): (leaf.full_tensor() if isinstance(leaf, DTensor)
                             else leaf).cpu()
            for path, leaf in tree_items(tree)}


def _distributed(specs, params, mesh, sharder):
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.models.params import tree_map
    return tree_map(lambda p, a: distribute_tensor(a, mesh,
                                                   sharder.param_sharding(p)),
                    specs, params)


def sharded_train_phase(torch, np, card):
    """Phase 18 (b) and (d): one full-width mamba2-1.3b step of one
    microbatch, plain and then on a (1, 1) mesh of DTensors, bit-equal;
    the sharded step counted by `roofline.counter`."""
    import dataclasses

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import Sharder
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import lm, model
    from repro_torch.models.params import tree_leaves
    from repro_torch.roofline.analysis import model_flops
    from repro_torch.roofline.counter import count_step
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.step import build_train_step
    run = train_run_config()
    run = dataclasses.replace(run, microbatches=1, fsdp=True,
                              shape=dataclasses.replace(
                                  run.shape, global_batch=DIST_TRAIN_B))
    cfg, seq = run.model, run.shape.seq_len
    opt_cfg = opt_mod.OptConfig()
    rng = np.random.RandomState(18)
    batch = {k: torch.tensor(rng.randint(0, cfg.vocab_size, (
        DIST_TRAIN_B, seq)), dtype=torch.int32, device="cuda")
        for k in ("tokens", "labels")}

    def fresh():
        return model.init_params(
            torch.Generator(device="cuda").manual_seed(0), cfg,
            device="cuda")

    R = cfg.n_layers
    per_micro = R + (R - R // lm._scan_group(R)) + R
    params = fresh()
    state = opt_mod.init(params, opt_cfg)
    ssd_intra_chunk.launches = 0
    t0 = time.perf_counter()
    params, state, metrics = build_train_step(cfg, run, opt_cfg)(
        params, state, batch)
    torch.cuda.synchronize()
    plain_s, plain_launches = time.perf_counter() - t0, \
        ssd_intra_chunk.launches
    want_loss = metrics["loss"].cpu()
    want = _host_tree(params)
    del params, state, metrics
    torch.cuda.empty_cache()

    mesh = make_host_mesh()
    try:
        sharder = Sharder(mesh, run)
        params = _distributed(model.param_specs(cfg), fresh(), mesh, sharder)
        state = opt_mod.init(params, opt_cfg)
        step = build_train_step(cfg, run, opt_cfg, sharder.constrain)
        torch.cuda.synchronize()
        ssd_intra_chunk.launches = 0
        t0 = time.perf_counter()
        (params, state, metrics), counts = count_step(step, params, state,
                                                      batch)
        torch.cuda.synchronize()
        sharded_s, launches = time.perf_counter() - t0, \
            ssd_intra_chunk.launches
        kinds = {type(leaf).__name__ for leaf in tree_leaves(params)}
        loss = metrics["loss"]
        loss = (loss.full_tensor() if isinstance(loss, DTensor)
                else loss).cpu()
        got = _host_tree(params)
        moments_sharded = all(
            isinstance(m, DTensor) for m in tree_leaves(state["m"]))
    finally:
        dist.destroy_process_group()
    del params, state, metrics
    torch.cuda.empty_cache()
    if launches != per_micro or plain_launches != per_micro:
        raise AssertionError(f"ssd launches: plain {plain_launches}, sharded "
                             f"{launches}, want {per_micro}")
    if not torch.equal(loss, want_loss):
        raise AssertionError(f"sharded loss {float(loss)!r} != plain "
                             f"{float(want_loss)!r}")
    differ = [k for k in want if not torch.equal(got[k], want[k])]
    if differ:
        worst = max(float((got[k].float() - want[k].float()).abs().max())
                    / max(float(want[k].float().abs().max()), 1e-30)
                    for k in differ)
        raise AssertionError(f"{len(differ)} updated leaves differ from the "
                             f"plain step (worst {worst:.3g} of max |p|): "
                             f"{differ[:6]}")
    if kinds != {"DTensor"} or not moments_sharded:
        raise AssertionError(f"params were {kinds}, moments DTensor: "
                             f"{moments_sharded}")
    shape = dataclasses.replace(run.shape, global_batch=DIST_TRAIN_B)
    mflops = model_flops(cfg, shape)
    log(f"[dist] (b) {cfg.name} one microbatch of {DIST_TRAIN_B} x {seq}, "
        f"AdamW, fsdp, on a (1, 1) DeviceMesh over a one-rank NCCL group: "
        f"loss {float(want_loss):.6f} and {len(want)} updated leaves "
        f"bit-equal to the plain step; ssd launches {launches} == "
        f"{per_micro} (plain {plain_launches}); step {plain_s:.2f} s plain, "
        f"{sharded_s:.2f} s sharded (with the counter on) [{card}]")
    log(f"[dist] (d) the sharded step's counter: dot_flops "
        f"{counts['dot_flops']:.6g} (aten products, and the SSD kernel's "
        f"own count of its products: {counts['kernels']}) beside "
        f"model_flops {mflops:.6g} (6 x active params x tokens); ratio "
        f"{counts['dot_flops'] / mflops:.4f}; HBM bytes "
        f"{counts['hbm_bytes']:.6g}, peak live bytes "
        f"{counts['peak_bytes']:.6g}; collective bytes "
        f"{counts['coll_bytes']:.6g} {counts['coll_by_op']} on one rank")
    return dict(arch=cfg.name, batch=DIST_TRAIN_B, seq=seq, mesh=[1, 1],
                loss=float(want_loss), leaves=len(want), launches=launches,
                plain_launches=plain_launches, plain_s=plain_s,
                sharded_s=sharded_s, dot_flops=counts["dot_flops"],
                model_flops=mflops, coll_bytes=counts["coll_bytes"],
                coll_by_op=counts["coll_by_op"],
                hbm_bytes=counts["hbm_bytes"], kernels=counts["kernels"])


def sharded_prefill_phase(torch, np, card, flash_attention_bhsd, want):
    """Phase 18 (c): qwen3-4b bf16 prefill on a (1, 1) mesh of DTensors
    through `Sharder.constrain`, logits bit-equal to phase 6's (`want`,
    on the host), flash on the wgmma route once a layer."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import Sharder
    from repro_torch.launch.mesh import make_host_mesh
    model, cfg, run, params = model_setup(torch, None)
    tokens = serve_tokens(torch, np, cfg)
    mesh = make_host_mesh()
    try:
        sharder = Sharder(mesh, run)
        params = _distributed(model.param_specs(cfg), params, mesh, sharder)
        zero_counts(flash_attention_bhsd)
        t0 = time.perf_counter()
        logits, caches = model.forward_prefill(
            cfg, run, params, {"tokens": tokens},
            max_len=SERVE_S + SERVE_NEW, constrain=sharder.constrain)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        was_dtensor = isinstance(logits, DTensor)
        got = (logits.full_tensor() if was_dtensor else logits).cpu()
    finally:
        dist.destroy_process_group()
    del params, caches, logits
    torch.cuda.empty_cache()
    routed(flash_attention_bhsd, "wgmma", cfg.n_layers,
           f"a sharded bf16 prefill of {cfg.n_layers} layers")
    if not was_dtensor or not torch.equal(got, want):
        raise AssertionError(
            f"sharded prefill logits (DTensor: {was_dtensor}) != phase 6's: "
            f"max |d| {float((got.float() - want.float()).abs().max())}")
    log(f"[dist] (c) {cfg.name} bf16 prefill of {SERVE_B} x {SERVE_S} on a "
        f"(1, 1) DeviceMesh: logits bit-equal to phase 6's; flash launches "
        f"{flash_attention_bhsd.launches} == {cfg.n_layers} layers on the "
        f"wgmma route, each on its local shard; {secs * 1e3:.1f} ms "
        f"[{card}]")
    return dict(arch=cfg.name, batch=SERVE_B, seq=SERVE_S, mesh=[1, 1],
                launches=flash_attention_bhsd.launches, s=secs)


# ---- phase 19: the dry run ------------------------------------------------

DRY_ARCH, DRY_SHAPE = "mamba2-1.3b", "prefill_32k"
DRY_SAME = ("argument_size_in_bytes", "output_size_in_bytes",
            "alias_size_in_bytes", "collective_bytes_by_op")
DRY_TRACKER_TOL = 0.15     # the counter's peak against the allocator's
DRY_CLI = ["--arch", "qwen3-4b", "--shape", "decode_32k", "--multi-pod",
           "both"]


def dryrun_route_phase(torch, card, ssd_intra_chunk):
    """Phase 19 (a) and (b): the full-width mamba2 prefill cell traced on
    the fake group on the CUDA route (the ssd kernel's fake branch, once a
    layer, no launch), then on the CPU route; the memory and collective
    keys equal. Any process group left running is ended first."""
    import torch.distributed as dist

    from repro_torch.configs import get_model
    from repro_torch.launch import dryrun
    if dist.is_initialized():        # the dry run starts its own group
        dist.destroy_process_group()
    layers = get_model(DRY_ARCH).n_layers
    launches, fakes = ssd_intra_chunk.launches, ssd_intra_chunk.fake_calls
    t0 = time.perf_counter()
    cuda = dryrun.lower_cell(DRY_ARCH, DRY_SHAPE, False, device="cuda")
    cuda_s = time.perf_counter() - t0
    fake_calls = ssd_intra_chunk.fake_calls - fakes
    if fake_calls != layers or ssd_intra_chunk.launches != launches:
        raise AssertionError(f"ssd fake calls {fake_calls} (want {layers}), "
                             f"launches {ssd_intra_chunk.launches - launches}"
                             " (want 0)")
    if dist.is_initialized():
        raise AssertionError("lower_cell left its process group running")
    r = cuda["roofline"]
    log(f"[dryrun] (a) {DRY_ARCH} {DRY_SHAPE} on the {cuda['mesh']} mesh "
        f"({cuda['chips']} fake ranks), CUDA route: ssd fake calls "
        f"{fake_calls} == {layers} layers, 0 launches; per rank: arguments "
        f"{cuda['argument_size_in_bytes']} B, outputs "
        f"{cuda['output_size_in_bytes']} B, temp "
        f"{cuda['temp_size_in_bytes']} B, hbm_per_device "
        f"{cuda['hbm_per_device_bytes']} B; parsed FLOPs "
        f"{cuda['parsed_flops_per_device']:.6g}, HBM bytes "
        f"{cuda['parsed_hbm_bytes_per_device']:.6g}, collectives "
        f"{cuda['collective_bytes_by_op']}; kernels {cuda['kernels']}; "
        f"roofline {r['dominant']} (compute {r['compute_s']:.4g} s, memory "
        f"{r['memory_s']:.4g} s, collective {r['collective_s']:.4g} s), "
        f"useful_flops_ratio {r['useful_flops_ratio']:.4f}; traced in "
        f"{cuda['compile_s']} s, {cuda_s:.1f} s in all [{card}]")
    t0 = time.perf_counter()
    cpu = dryrun.lower_cell(DRY_ARCH, DRY_SHAPE, False, device="cpu")
    cpu_s = time.perf_counter() - t0
    differ = {k: (cuda[k], cpu[k]) for k in DRY_SAME if cuda[k] != cpu[k]}
    if differ:
        raise AssertionError(f"the routes' reports differ: {differ}")
    ratio = cuda["parsed_flops_per_device"] / cpu["parsed_flops_per_device"]
    log(f"[dryrun] (b) the same cell on the CPU route (the plain SSD): "
        f"{', '.join(DRY_SAME)} equal (a)'s; parsed FLOPs "
        f"{cpu['parsed_flops_per_device']:.6g} against the CUDA route's "
        f"{cuda['parsed_flops_per_device']:.6g} (ratio {ratio:.4f}: the "
        f"kernel's own count of its products replaces the plain version's "
        f"einsums), HBM bytes {cpu['parsed_hbm_bytes_per_device']:.6g}, "
        f"hbm_per_device {cpu['hbm_per_device_bytes']} B; {cpu_s:.1f} s "
        f"[{card}]")
    return dict(cell=f"{DRY_ARCH}__{DRY_SHAPE}__pod1", fake_calls=fake_calls,
                cuda={k: cuda[k] for k in (
                    "argument_size_in_bytes", "temp_size_in_bytes",
                    "hbm_per_device_bytes", "parsed_flops_per_device",
                    "parsed_hbm_bytes_per_device",
                    "collective_bytes_per_device", "kernels")},
                cpu_flops=cpu["parsed_flops_per_device"], flops_ratio=ratio,
                dominant=r["dominant"], cuda_s=cuda_s, cpu_s=cpu_s)


def dryrun_tracker_phase(torch, np, card, flash_attention_bhsd):
    """Phase 19 (c): qwen3-4b's 4 x 2048 bf16 prefill for real (the rise of
    `max_memory_allocated` above the bytes allocated before the call),
    then traced under `FakeTensorMode` (the params and tokens made fake)
    with the counter's live-bytes tracker: peaks within DRY_TRACKER_TOL."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.params import tree_map
    from repro_torch.roofline.counter import StepCounter
    model, cfg, run, params = model_setup(torch, None)
    tokens = serve_tokens(torch, np, cfg)
    max_len = SERVE_S + SERVE_NEW
    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        logits, caches = model.forward_prefill(
            cfg, run, params, {"tokens": tokens}, max_len=max_len)
        torch.cuda.synchronize()
        rise = torch.cuda.max_memory_allocated() - base
        del logits, caches
        mode = FakeTensorMode()
        fparams = tree_map(mode.from_tensor, params)
        ftokens = mode.from_tensor(tokens)
        fakes = flash_attention_bhsd.fake_calls
        with mode, StepCounter() as counter:
            out = model.forward_prefill(cfg, run, fparams,
                                        {"tokens": ftokens}, max_len=max_len)
            peak = counter.peak
        del out
    del params, fparams
    torch.cuda.empty_cache()
    share = peak / rise
    if abs(share - 1) > DRY_TRACKER_TOL:
        raise AssertionError(f"tracker peak {peak} B against the allocator's "
                             f"{rise} B ({share:.4f})")
    log(f"[dryrun] (c) {cfg.name} prefill {SERVE_B} x {SERVE_S}: allocator "
        f"rise {rise} B, the counter's traced peak {peak} B ({share:.4f} of "
        f"it, limit 1 +- {DRY_TRACKER_TOL}); flash fake calls "
        f"{flash_attention_bhsd.fake_calls - fakes} [{card}]")
    return dict(allocator_rise=rise, tracker_peak=peak, share=share)


def dryrun_cli_phase(card):
    """Phase 19 (d): the dry run's CLI in subprocesses: DRY_CLI writes two
    reports, both ok, and exits 0; long_500k of a full-attention arch
    prints the reference's skip line."""
    import os
    import tempfile
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [os.environ.get("PYTHONPATH")]
                               if p]))
    cli = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run(cli + DRY_CLI + ["--out", tmp], cwd=ROOT,
                              env=env, capture_output=True, text=True,
                              timeout=600)
        names = sorted(os.listdir(tmp))
        reports = [json.loads(Path(tmp, n).read_text()) for n in names]
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("[")]
    failed = [rep.get("traceback", "")[-3000:] for rep in reports
              if "error" in rep]
    if proc.returncode != 0 or len(reports) != 2 or failed:
        raise AssertionError(f"dryrun CLI exited {proc.returncode}, reports "
                             f"{names}:\n{proc.stdout}\n"
                             f"{proc.stderr[-4000:]}\n" + "\n".join(failed))
    skip = subprocess.run(cli + ["--arch", "qwen3-4b", "--shape",
                                 "long_500k"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    want = ("[SKIP] qwen3-4b__long_500k (long_500k needs sub-quadratic "
            "attention; see DESIGN.md §4)")
    if skip.returncode != 0 or want not in skip.stdout.splitlines():
        raise AssertionError(f"long_500k: exit {skip.returncode}, "
                             f"{skip.stdout!r}")
    for ln in lines:
        log(f"[dryrun] (d) | {ln}")
    for rep in reports:
        log(f"[dryrun] (d) {rep['arch']} {rep['shape']} {rep['mesh']}: "
            f"hbm_per_device {rep['hbm_per_device_bytes']} B, collectives "
            f"{rep['collective_bytes_by_op']}, roofline "
            f"{rep['roofline']['dominant']}")
    log(f"[dryrun] (d) CLI {' '.join(DRY_CLI)}: exit 0, {names}, "
        f"{wall:.1f} s; long_500k skipped as the reference [{card}]")
    return dict(reports=names, wall_s=wall)


def misaligned(torch, t, elems=1):
    """A copy of `t` whose storage starts `elems` elements into a fresh
    allocation: off 16-byte alignment for 2- and 4-byte elements."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    return flat[elems:].view(t.shape).copy_(t)


def strided(torch, t, pad):
    """A copy of `t` as a view of rows `pad` elements longer than its last
    dim: not contiguous, its row stride (dh + pad) off 16 bytes for the
    pads used here."""
    buf = torch.zeros(tuple(t.shape[:-1]) + (t.shape[-1] + pad,),
                      dtype=t.dtype, device=t.device)
    return buf[..., :t.shape[-1]].copy_(t)


def refused(fn, match, counter, what):
    """Raise unless `fn()` raises ValueError naming `match` without a
    launch (`counter()` unchanged)."""
    before = counter()
    try:
        fn()
    except ValueError as e:
        if match not in str(e):
            raise AssertionError(f"{what}: refused for another reason: {e}")
    else:
        raise AssertionError(f"{what}: not refused")
    if counter() != before:
        raise AssertionError(f"{what}: launched before refusing")
    return match


def contract_entry(name, source, replaces, launches, err, t, **extra):
    """One kernel of the JSON line from a phase-20 timing `t`."""
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=err, ms=t["ms"],
                plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                bound_by=t["bound_by"], library_ms=t.get("library_ms"),
                **extra)


def contract_flash(torch, np, kernel, card):
    """Phase 20, flash: the wide and odd heads, H = 8 over one KV head and
    staged layouts on both routes, the refusals, then dh 256 timed."""
    from repro_torch.kernels.flash_attention.kernel import plan
    from repro_torch.kernels.flash_attention.ref import attention_ref
    errs, counts, entries = {}, {}, []
    for dtype, kind in (("float32", "split_tf32"), ("bfloat16", "wgmma")):
        zero_counts(kernel)
        kernel.staged = 0
        bf16 = dtype == "bfloat16"
        errs[dtype], want_staged = [], 0
        for S, H, KV, dh, causal, window in CONTRACT_FLASH:
            q, k, v = flash_inputs(torch, np, S, H, KV, dh, dtype, S + dh)
            errs[dtype].append(flash_compare(
                torch, kernel, attention_ref, q, k, v, causal, window,
                FLASH_TOL[dtype], rounding=bf16, block_q=S, block_k=S)[0])
            want_staged += plan(q.dtype, dh).staged
        # a q off 16 bytes, and a k whose rows are off 16 bytes: staged
        q, k, v = flash_inputs(torch, np, 200, 8, 2, 128, dtype, 5)
        for qq, kk in ((misaligned(torch, q), k),
                       (q, strided(torch, k.transpose(1, 2), 4 if bf16 else 2)
                        .transpose(1, 2))):
            errs[dtype].append(flash_compare(
                torch, kernel, attention_ref, qq, kk, v, True, None,
                FLASH_TOL[dtype], rounding=bf16, block_q=200,
                block_k=200)[0])
        want_staged += 2
        n = len(CONTRACT_FLASH) + 2
        routed(kernel, kind, n, f"{dtype} contracts")
        if kernel.staged != want_staged:
            raise AssertionError(f"flash {dtype}: {kernel.staged} staged "
                                 f"calls, want {want_staged}")
        counts[dtype] = dict(launches=n, staged=kernel.staged)
    for dh, dtype, match in ((264, "bfloat16", "head dim 264"),
                             (64, "float16", "must share one of")):
        q, k, v = flash_inputs(torch, np, 64, 2, 1, dh, dtype, 1)
        refused(lambda: kernel(q, k, v), match, lambda: kernel.launches,
                f"flash dh {dh} {dtype}")
    log(f"[contracts] flash == plain version at dh 80/100/192/256, H 8 "
        f"over KV 1 and 2, causal, windowed and bidirectional, and on a q "
        f"off 16 bytes and a k with rows off 16 bytes (staged), each "
        f"route: launches and staged calls {counts} (max |err| fp32 "
        f"{max(errs['float32']):.3g} within 2e-5, bf16 "
        f"{max(errs['bfloat16']):.3g} within the rounding bound); dh 264 "
        f"and float16 refused with no launch [{card}]")

    B, S, H, KV, dh = CONTRACT_FLASH_TIMED
    for dtype, kind, rate, passes in (
            ("bfloat16", "wgmma", BF16_TENSOR_FLOPS, 1),
            ("float32", "split_tf32", TF32_TENSOR_FLOPS, TF32_PASSES)):
        bf16 = dtype == "bfloat16"
        q, k, v = flash_inputs(torch, np, S, H, KV, dh, dtype, 0, B=B)
        zero_counts(kernel)
        err, share, typical = flash_compare(
            torch, kernel, attention_ref, q, k, v, True, None,
            FLASH_TOL[dtype], rounding=bf16)
        routed(kernel, kind, 1, f"dh {dh} timed case")
        t = flash_timing(torch, np, kernel, q, k, v, rate, passes)
        log(f"[contracts] flash B={B} S={S} H={H} KV={KV} dh={dh} causal "
            f"{dtype} ({kind}, instance {plan(q.dtype, dh).instance}): max "
            f"|err| {err:.3g}, {share:.3g}x the "
            f"{'rounding bound' if bf16 else 'tol'}; kernel {t['ms']:.4f} "
            f"ms on the device ({t['tflops']:.1f} TFLOP/s, "
            f"{t['bound_share']:.3f} of the bound), {t['launch_ms']:.4f} ms "
            f"per launch from Python; plain version {t['plain_ms']:.3f} ms; "
            f"scaled_dot_product_attention {t['library_ms']:.4f} ms; bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} ({passes} x "
            f"{t['flops']:.4g} flop, {t['nbytes']:.4g} B) [{card}]")
        entries.append(contract_entry(
            "flash_attention_dh256" if bf16 else "flash_attention_fp32_dh256",
            FLASH_SOURCES[kind],
            "src/repro/kernels/flash_attention/kernel.py:26",
            counts[dtype]["launches"], max(errs[dtype] + [err]), t,
            kernel=kind, launch_ms=t["launch_ms"],
            staged=counts[dtype]["staged"],
            shape=dict(B=B, S=S, H=H, KV=KV, dh=dh, dtype=dtype,
                       causal=True)))
        del q, k, v
        torch.cuda.empty_cache()
    return entries


def paged_bound(torch, q, k_pages, table, seq_lens):
    """Phase 11's bound of one call: the live K and V rows, q, o, the
    table and the lengths, each once, over the HBM rate, against 4 H dh
    flop a live token at the bf16 tensor rate."""
    B, H, dh = q.shape
    KV = k_pages.shape[2]
    tokens = int(seq_lens.sum())
    nbytes = (2 * tokens * KV * dh * k_pages.element_size()
              + 2 * q.numel() * q.element_size() + table.numel() * 4 + B * 4)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 4 * H * dh * tokens / BF16_TENSOR_FLOPS * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def contract_paged(torch, np, card):
    """Phase 20, paged: G 32 and 71, dh 80/100/256, staged layouts, the
    refusals, then G 32 and 71 timed at the pool's lengths."""
    from repro_torch.kernels.paged_attention.kernel import (paged_attention,
                                                            plan)
    from repro_torch.kernels.paged_attention.ref import paged_attention_ref
    errs, counts = [], {}
    for dtype in ("float32", "bfloat16"):
        paged_attention.launches = paged_attention.staged = 0
        tol, want_staged, calls = PAGED_TOL[dtype], 0, []
        for case in CONTRACT_PAGED:
            args = paged_inputs(torch, np, *case, dtype)
            calls.append((case, args))
            want_staged += plan(args[0].dtype, case[3],
                                case[1] // case[2]).staged
        q, kp, vp, bt, sl = paged_inputs(torch, np, 3, 8, 2, 64, 16, 6,
                                         dtype)
        calls.append(("q off 16 bytes",
                      (misaligned(torch, q), kp, vp, bt, sl)))
        calls.append(("q not contiguous",
                      (strided(torch, q, 8), kp, vp, bt, sl)))
        want_staged += 2
        for case, args in calls:
            got = paged_attention(*args).float()
            want = paged_attention_ref(*args).float()
            torch.cuda.synchronize()
            err = (got - want).abs()
            errs.append(float(err.max()))
            if bool((err > tol + tol * want.abs()).any()):
                raise AssertionError(f"paged kernel != plain version {case} "
                                     f"{dtype}: max |err| {errs[-1]:.3g}")
        if paged_attention.launches != len(calls) \
                or paged_attention.staged != want_staged:
            raise AssertionError(f"paged {dtype}: {paged_attention.launches}"
                                 f" calls, {paged_attention.staged} staged; "
                                 f"want {len(calls)}, {want_staged}")
        counts[dtype] = dict(launches=len(calls), staged=want_staged)
    for dh, dtype, match in ((264, "bfloat16", "head dim 264"),
                             (64, "float16", "float16")):
        args = paged_inputs(torch, np, 2, 4, 2, dh, 8, 2, dtype)
        refused(lambda: paged_attention(*args), match,
                lambda: paged_attention.launches, f"paged dh {dh} {dtype}")
    log(f"[contracts] paged == plain version at G 32 and 71 (one KV head), "
        f"142 heads over 2, dh 256, 80 and 100, and a q off 16 bytes and "
        f"one not contiguous (staged), both dtypes: calls and staged "
        f"{counts} (atol = rtol = 2e-5 fp32, 3e-2 bf16; max |err| "
        f"{max(errs):.3g}); dh 264 and float16 refused with no launch "
        f"[{card}]")

    entries = []
    lens = pool_lens(np) + POOL["steps"]
    for B, H, KV, dh, page, npp in CONTRACT_PAGED_TIMED:
        args = paged_inputs(torch, np, B, H, KV, dh, page, npp, "bfloat16",
                            lens)
        how = plan(args[0].dtype, dh, H // KV)
        paged_attention.launches = 0
        got = paged_attention(*args)
        want = paged_attention_ref(*args)
        gathered = args[3].long()
        T = npp * page
        kg = args[1][gathered].reshape(B, T, KV, dh)
        vg = args[2][gathered].reshape(B, T, KV, dh)
        _, spread = dense_decode(torch, args[0], kg, vg, args[4])
        del kg, vg
        err, share = rounding_check(torch, got, want, spread,
                                    f"paged kernel at G {H // KV}")
        run = lambda: paged_attention(*args)             # noqa: E731
        t = dict(ms=time_events(torch, run, 20),
                 launch_ms=time_host(torch, run, 10),
                 plain_ms=time_events(
                     torch, lambda: paged_attention_ref(*args), 3, 1))
        t["bound_ms"], t["bound_by"] = paged_bound(torch, args[0], args[1],
                                                   args[3], args[4])
        log(f"[contracts] paged B={B} H={H} KV={KV} (G {H // KV}: "
            f"{how.groups} groups of {how.heads} heads) dh={dh} page={page}, "
            f"{int(args[4].sum())} live tokens, bf16: max |err| {err:.3g}, "
            f"{share:.3g}x the rounding bound; kernel {t['ms']:.4f} ms on "
            f"the device, {t['launch_ms']:.4f} ms per call from Python; "
            f"plain version {t['plain_ms']:.3f} ms; bound "
            f"{t['bound_ms']:.4f} ms by {t['bound_by']} [{card}]")
        entries.append(contract_entry(
            f"paged_attention_g{H // KV}",
            "src/repro_torch/csrc/paged_attention.cu",
            "src/repro/kernels/paged_attention/kernel.py:31",
            sum(c["launches"] for c in counts.values()), max(errs + [err]),
            t, launch_ms=t["launch_ms"],
            staged=sum(c["staged"] for c in counts.values()),
            shape=dict(B=B, H=H, KV=KV, dh=dh, page=page, pages_per_seq=npp,
                       live_tokens=int(args[4].sum()), dtype="bfloat16",
                       groups=how.groups, heads=how.heads)))
    return entries


def ssd_args(torch, np, S, nh, hd, ds, chunk):
    """The reference test's draw, chunked for the intra-chunk kernel."""
    from repro_torch.kernels.ssd_scan import ops
    rng = np.random.RandomState(S + nh)
    arrays = [rng.randn(2, S, nh, hd) * .5,
              np.abs(rng.randn(2, S, nh)) * .1 + .02,
              -np.abs(rng.randn(nh)) * .5 - .1,
              rng.randn(2, S, ds) * .5, rng.randn(2, S, ds) * .5]
    return ops.chunk_inputs(*(torch.tensor(a, dtype=torch.float32,
                                           device="cuda") for a in arrays),
                            chunk)


def contract_ssd(torch, np, card):
    """Phase 20, ssd: hd and ds past the tiles (the WIDE instances, with
    and without cs windows), a non-contiguous x, the refusal, then hd 128
    / ds 256 timed."""
    from repro_torch.kernels.ssd_scan import kernel as kmod
    from repro_torch.kernels.ssd_scan import ops
    from repro_torch.kernels.ssd_scan.ref import ssd_intra_chunk_ref
    kernel = kmod.ssd_intra_chunk
    kernel.launches = kernel.staged = 0
    errs = []
    for case in CONTRACT_SSD:
        errs.append(ssd_compare(torch, kernel, ssd_intra_chunk_ref,
                                ssd_args(torch, np, *case), SSD_TOL)[0])
    x, dA, Bm, Cm = ssd_args(torch, np, *CONTRACT_SSD[0])
    errs.append(ssd_compare(torch, kernel, ssd_intra_chunk_ref,
                            (strided(torch, x, 4), dA, Bm, Cm), SSD_TOL)[0])
    n = len(CONTRACT_SSD) + 1
    if kernel.launches != n or kernel.staged != 1:
        raise AssertionError(f"ssd: {kernel.launches} launches, "
                             f"{kernel.staged} staged; want {n}, 1")
    counts = dict(launches=n, staged=kernel.staged)
    z = torch.zeros(1, 1, kmod.Q_MAX + 1, 1, 1, device="cuda")
    zb = torch.zeros(1, 1, kmod.Q_MAX + 1, 1, device="cuda")
    refused(lambda: kernel(z, zb[..., 0:1], zb, zb), "chunk 30657",
            lambda: kernel.launches, "ssd chunk 30657")
    log(f"[contracts] ssd == plain version at hd/ds 128/256, 100/200, "
        f"256/256 over a chunk of 1040 rows (windows) and 128/64, and on a "
        f"non-contiguous x (staged): {counts} (atol = rtol = {SSD_TOL}; max "
        f"|err| {max(errs):.3g}); a chunk of 30657 rows refused with no "
        f"launch [{card}]")

    sv = CONTRACT_SSD_TIMED
    B_, S, nh, hd, ds, Q = (sv[k] for k in ("B", "S", "nh", "hd", "ds", "Q"))
    gen = torch.Generator(device="cuda").manual_seed(8)

    def draw(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x, B, C = draw(B_, S, nh, hd) * .5, draw(B_, S, ds) * .5, \
        draw(B_, S, ds) * .5
    dt = torch.rand((B_, S, nh), generator=gen, device="cuda") * .1 + .02
    A = -(torch.rand((nh,), generator=gen, device="cuda") * .5 + .1)
    args = ops.chunk_inputs(x, dt, A, B, C, Q)
    err, share = ssd_compare(torch, kernel, ssd_intra_chunk_ref, args)
    run = lambda: kernel(*args)                           # noqa: E731
    t = dict(ms=time_events(torch, run, 20),
             launch_ms=time_host(torch, run, 10),
             plain_ms=time_events(torch, lambda: ssd_intra_chunk_ref(*args),
                                  3, 1))
    nc = S // Q
    products, nbytes = kmod.work(B_, nc, Q, nh, hd, ds)
    pairs = Q * (Q + 1) // 2
    elementwise = B_ * nc * nh * (2 * pairs + Q * hd + Q)
    terms = {"operations": max(3 * products / TF32_TENSOR_FLOPS,
                               elementwise / CUDA_CORE_OPS_PER_S) * 1e3,
             "bytes": nbytes / HBM_BYTES_PER_S * 1e3}
    t["bound_by"] = max(terms, key=terms.get)
    t["bound_ms"] = terms[t["bound_by"]]
    how = kmod.plan(hd, ds, Q)
    log(f"[contracts] ssd B={B_} S={S} nh={nh} hd={hd} ds={ds} Q={Q} fp32 "
        f"({how.hd_slices} hd slices x {how.ds_slices} ds slices): max "
        f"|err| {err:.3g}, {share:.3g}x the sum-of-|terms| limit; kernel "
        f"{t['ms']:.4f} ms on the device ({t['bound_ms'] / t['ms']:.3f} of "
        f"the bound), {t['launch_ms']:.4f} ms per launch from Python; "
        f"plain version {t['plain_ms']:.3f} ms; bound {t['bound_ms']:.4f} "
        f"ms by {t['bound_by']} ({products:.4g} flop x 3 split-TF32 passes, "
        f"{elementwise:.4g} elementwise ops, {nbytes:.4g} B) [{card}]")
    del x, B, C, dt, args
    torch.cuda.empty_cache()
    return [contract_entry(
        "ssd_scan_hd128_ds256", "src/repro_torch/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan/kernel.py:29", counts["launches"],
        max(errs + [err]), t, launch_ms=t["launch_ms"],
        staged=counts["staged"], shape=dict(sv, dtype="float32"))]


def contract_tlb(torch, np, card, fused_tlb_round, fused_tlb_access_ref):
    """Phase 20, fused_tlb: more lanes than threads, planes of 5 ways at R
    = 2 (rows off 16 bytes), 16-way planes off 16 bytes; bit-equal. Then
    1056 lanes timed."""
    from repro_torch.kernels.fused_tlb.kernel import instance, rows_aligned
    fused_tlb_round.launches = 0
    cases = [path_case(np, *shape, masks, seed=sum(shape))
             for shape in CONTRACT_TLB for masks in ("all", "half")]
    rng = np.random.RandomState(35)
    rows = []
    for _ in range(2):           # two rows of (3, 5) planes: 60 B a row
        rows.append(dict(
            tags=rng.randint(-1, 40, (3, 5)).astype(np.int32),
            asids=rng.randint(0, 3, (3, 5)).astype(np.int32),
            lru=rng.randint(0, 100, (3, 5)).astype(np.int32),
            vpn=rng.randint(0, 50, (24,)).astype(np.int32),
            asid=rng.randint(0, 3, (24,)).astype(np.int32),
            active=rng.rand(24) > 0.25, may_fill=rng.rand(24) > 0.2,
            time=77, n_waves=6, track_asids=True))
    cases.append(stack_cases(np, rows))
    err = max(compare(torch, fused_tlb_round, fused_tlb_access_ref, c)
              for c in cases)
    # 16-way planes 4 bytes off 16-byte alignment: the word-reading instance
    case = path_case(np, *L2_SHAPE, "half", seed=36)
    ka, kw = on_card(torch, case)
    pa, _ = on_card(torch, case)
    ka[:3] = [misaligned(torch, t) for t in ka[:3]]
    if instance(16, rows_aligned(ka[:3], 1)) != 0:
        raise AssertionError("misaligned 16-way planes not planned onto "
                             "the word-reading instance")
    for a, b, name in zip(fused_tlb_round(*ka, case["time"], **kw),
                          fused_tlb_access_ref(*pa, case["time"], **kw),
                          ("tags", "asids", "lru", "hit", "filled")):
        if not torch.equal(a, b):
            raise AssertionError(f"fused_tlb on misaligned planes != plain "
                                 f"version on {name}")
    launches = fused_tlb_round.launches
    if launches != len(cases) + 1:
        raise AssertionError(f"fused_tlb launched {launches} times for "
                             f"{len(cases) + 1} rounds")
    log(f"[contracts] fused_tlb == plain version, bit for bit, at 1056 and "
        f"2048 lanes (wide instances), on (3, 5) planes at R = 2 and on "
        f"16-way planes 4 bytes off 16-byte alignment (the word-reading "
        f"instance): {launches} launches (max |err| {err}) [{card}]")

    case = path_case(np, *CONTRACT_TLB[0], "half", seed=1)
    args, kw = on_card(torch, case)
    out = fused_tlb_access_ref(*args, case["time"], **kw)
    least, bound_by = bound(np, case, [t.cpu().numpy() for t in out])
    t = dict(ms=time_round_graph(torch, fused_tlb_round, case, 200),
             launch_ms=time_round(torch, fused_tlb_round, case, 500),
             plain_ms=time_round(torch, fused_tlb_access_ref, case, 50),
             bound_ms=least, bound_by=bound_by)
    log(f"[contracts] fused_tlb L2 round 1024x16, N=1056, W=8 (132 cores): "
        f"kernel {t['ms'] * 1e3:.2f} us on the device (graph replay), "
        f"{t['launch_ms'] * 1e3:.2f} us per launch from Python; plain "
        f"version {t['plain_ms'] * 1e3:.2f} us; bound {least * 1e3:.4f} us "
        f"by {bound_by} [{card}]")
    return [contract_entry(
        "fused_tlb_1056_lanes", "src/repro_torch/csrc/fused_tlb.cu",
        "src/repro/kernels/fused_tlb/kernel.py:44", launches, err, t,
        launch_ms=t["launch_ms"], shape=dict(sets=1024, ways=16, lanes=1056,
                                             waves=8))]


def contracts_phase(torch, np, card, fused_tlb_round, fused_tlb_access_ref,
                    flash_attention_bhsd):
    """Phase 20: the inputs the card once refused, on the hand-written
    kernels. Returns the new instances' entries of the JSON line."""
    t0 = time.perf_counter()
    entries = contract_flash(torch, np, flash_attention_bhsd, card)
    entries += contract_paged(torch, np, card)
    entries += contract_ssd(torch, np, card)
    entries += contract_tlb(torch, np, card, fused_tlb_round,
                            fused_tlb_access_ref)
    log(f"[contracts] phase 20 took {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    return entries


# ---- phase 21: the step's CUDA graphs ---------------------------------------
REPLAY_CYCLES = 200                   # the benchmark cells' calls
REPLAY_EPOCH, REPLAY_EPOCH_CYCLES = 40, 130
REPLAY_PROFILED = 5                   # cycles a launch count profiles
REPLAY_TRACE_SEED = 21
# runtime calls that put work on the card: a Python launch each
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                "cudaMemsetAsync"}


def replay_rows(n_apps):
    """Every bundle of `n_apps` distinct benchmarks outside the (low, low)
    class, then a solo row per benchmark: 325 rows of 2, 2,325 of 3."""
    import itertools

    from repro_torch.sim.workloads import BENCHES, CATEGORY
    elig = sorted(b for b in BENCHES if CATEGORY[b] != ("low", "low"))
    return list(itertools.combinations(elig, n_apps)) + [
        (b,) + (None,) * (n_apps - 1) for b in elig]


def bitwise(torch, got, want, what):
    """Every leaf of two states equal bit for bit (floats by their bits)."""
    from repro_torch.sim.replay import _leaves
    a, b = _leaves(got), _leaves(want)
    if len(a) != len(b):
        raise AssertionError(f"{what}: {len(a)} leaves against {len(b)}")
    for i, (x, y) in enumerate(zip(a, b)):
        if x.is_floating_point():
            x, y = x.view(torch.int32), y.view(torch.int32)
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"{what}: state leaf {i} differs")


def launches_a_cycle(torch, step, st, cycle, n=REPLAY_PROFILED):
    """(Python launches, device ms) a cycle over `n` cycles of `step`
    after one more from `st` at `cycle` (which copies a graphed key's
    state in), in a `torch.profiler` window, and the launches by runtime
    call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        st = step(st, cycle)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            for c in range(cycle + 1, cycle + 1 + n):
                st = step(st, c)
        torch.cuda.synchronize()
    ev = prof.events()
    calls = collections.Counter(e.name for e in ev if e.name in LAUNCH_CALLS)
    dev_us = sum(e.self_device_time_total for e in ev
                 if e.device_type == DeviceType.CUDA)
    return sum(calls.values()) / n, dev_us / 1e3 / n, dict(calls)


def replay_entry_bytes(torch):
    """(the memory pool's bytes, the static buffers' bytes) of the cache's
    most recently used key."""
    from repro_torch.sim import replay
    e = next(reversed(replay.GRAPHS.entries.values()))
    pool = sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(e.pool))
    bufs = replay._leaves(e.state) + [e.params] + list(e.knobs.values())
    return pool, sum(x.numel() * x.element_size() for x in bufs)


def replay_case(torch, card, tag, cfg, dp, pm):
    """One pass graphed (`runner.simulate`) against a plain eager loop of
    `memsys.eager_step`, bit for bit; the host ms a pass-cycle, the
    Python launches a cycle and the device ms a cycle of each; the key's
    pool and buffer bytes."""
    from repro_torch.sim import memsys, replay, runner
    R, cycles = pm.shape[0], cfg.sim_cycles
    out = {"rows": R, "cycles": cycles}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        st = memsys.init_state(cfg, dp, rows=R)
        for cycle in range(cycles):
            st = memsys.eager_step(cfg, dp, pm, st, cycle)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    eager = st
    out["eager_host_ms"] = (t1 - t0) * 1e3 / cycles
    out["eager_wall_ms"] = (time.perf_counter() - t0) * 1e3 / cycles
    captures = replay.GRAPHS.captures
    first = runner.simulate(cfg, dp, pm)   # warm: eager, capture, replays
    bitwise(torch, first, eager, f"{tag} (the capturing pass)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graphed = runner.simulate(cfg, dp, pm)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    out["graphed_host_ms"] = (t1 - t0) * 1e3 / cycles
    out["graphed_wall_ms"] = (time.perf_counter() - t0) * 1e3 / cycles
    bitwise(torch, graphed, eager, tag)
    out["captures"] = replay.GRAPHS.captures - captures
    out["pool_bytes"], out["buffer_bytes"] = replay_entry_bytes(torch)
    out["graphed_launches"], out["graphed_device_ms"], calls = \
        launches_a_cycle(torch, lambda s, c: memsys.step(cfg, dp, pm, s, c),
                         graphed, cycles)
    out["eager_launches"], out["eager_device_ms"], _ = launches_a_cycle(
        torch, lambda s, c: memsys.eager_step(cfg, dp, pm, s, c), eager,
        cycles)
    log(f"[replay] {tag}: {R} rows x {cycles} cycles graphed == eager bit "
        f"for bit; host ms a pass-cycle {out['graphed_host_ms']:.3f} "
        f"graphed ({out['graphed_wall_ms']:.3f} with the device) against "
        f"{out['eager_host_ms']:.3f} eager ({out['eager_wall_ms']:.3f}); "
        f"Python launches a cycle {out['graphed_launches']:.1f} against "
        f"{out['eager_launches']:.1f} (graphed, by call over "
        f"{REPLAY_PROFILED} cycles: {calls}); device ms a cycle "
        f"{out['graphed_device_ms']:.3f} against "
        f"{out['eager_device_ms']:.3f}; pool {out['pool_bytes']} B, "
        f"buffers {out['buffer_bytes']} B; {out['captures']} capture(s) "
        f"[{card}]")
    return out


def replay_phase(torch, np, card, fused_tlb_round):
    """Phase 21: the graphed step against the eager one on the card.
    Returns what each case logged."""
    from repro_torch.core.design import (design_params, get_design,
                                         stack_params)
    from repro_torch.sim import faults, memsys, replay, runner
    from repro_torch.sim.config import SimConfig
    from repro_torch.sim.workloads import (app_matrix, churn_schedule,
                                           pair_workloads)

    def pm_of(rows):
        return torch.tensor(np.stack([app_matrix(m) for m in rows]),
                            device="cuda")

    out = {}
    # (a) grid2's stacked pass: 7 designs x 325 rows, every knob per row
    rows2 = replay_rows(2)
    group = ["pwc", "gpu-mmu", "static", "mask", "mask-tlb", "mask-cache",
             "mask-dram"]
    cfg = runner._canonical(SimConfig(n_apps=2, design=get_design("mask"),
                                      sim_cycles=REPLAY_CYCLES,
                                      device="cuda"))
    dp = stack_params([design_params(n) for n in group], len(rows2), "cuda")
    out["a"] = replay_case(torch, card, "(a) grid2's stacked pass", cfg, dp,
                           pm_of(rows2 * len(group)))
    # (b) mask over every 3-app bundle
    rows3 = replay_rows(3)
    cfg = SimConfig(n_apps=3, design="mask", sim_cycles=REPLAY_CYCLES,
                    device="cuda")
    out["b"] = replay_case(torch, card, "(b) mask, 3-app", cfg,
                           design_params(cfg.design), pm_of(rows3))
    # (c) mask and gpu-mmu stacked, the epoch cut to 40: three epochs
    ds = [get_design(n).with_(epoch_cycles=REPLAY_EPOCH)
          for n in ("mask", "gpu-mmu")]
    sub = rows3[:200]
    cfg = SimConfig(n_apps=3, design=ds[0], sim_cycles=REPLAY_EPOCH_CYCLES,
                    device="cuda")
    dp = stack_params([design_params(d) for d in ds], len(sub), "cuda")
    out["c"] = replay_case(torch, card, "(c) mask + gpu-mmu, epoch 40", cfg,
                           dp, pm_of(sub * 2))
    # (d) run_trace with churn, a random fault plan and the audit
    sched = churn_schedule(REPLAY_TRACE_SEED, CHURN_SEGMENTS, CHURN_SLOTS)
    plan = faults.random_plan(REPLAY_TRACE_SEED, CHURN_SEGMENTS, CHURN_SLOTS)
    kw = dict(seg_cycles=CHURN_SEG, fault_plan=plan, audit=True,
              device="cuda", return_state=True)
    n = CHURN_SEGMENTS * CHURN_SEG
    launches = fused_tlb_round.launches
    t0 = time.perf_counter()
    graphed = runner.run_trace("mask", sched, **kw)
    t_graphed = time.perf_counter() - t0
    if fused_tlb_round.launches - launches != n:
        raise AssertionError(f"(d): {fused_tlb_round.launches - launches} "
                             f"fused_tlb launches for {n} cycles")
    step = runner.step
    runner.step = memsys.eager_step
    try:
        t0 = time.perf_counter()
        eager = runner.run_trace("mask", sched, **kw)
        t_eager = time.perf_counter() - t0
    finally:
        runner.step = step
    for k, (a, b) in enumerate(zip(graphed.segments, eager.segments)):
        for key in a:
            if np.asarray(a[key], np.float64).tobytes() != \
                    np.asarray(b[key], np.float64).tobytes():
                raise AssertionError(f"(d): segment {k} {key} differs")
    bitwise(torch, graphed.final_state, eager.final_state, "(d) trace")
    out["d"] = {"segments": CHURN_SEGMENTS, "seg_cycles": CHURN_SEG,
                "faults": len(plan.faults), "graphed_ms": t_graphed * 1e3 / n,
                "eager_ms": t_eager * 1e3 / n}
    # the trace's step past its end, from its final state: a segment's key
    # (its canonical config, `mask`'s own knobs)
    cfg = runner._canonical(SimConfig(n_apps=CHURN_SLOTS, design="mask",
                                      sim_cycles=CHURN_SEG, device="cuda"))
    dp = design_params(get_design("mask"))
    captures = replay.GRAPHS.captures
    pm = pm_of(sched[-1:])
    st = memsys.map_state(lambda x: x[None], graphed.final_state)
    out["d"]["graphed_launches"], _, calls = launches_a_cycle(
        torch, lambda s, c: memsys.step(cfg, dp, pm, s, c), st, n)
    out["d"]["eager_launches"], _, _ = launches_a_cycle(
        torch, lambda s, c: memsys.eager_step(cfg, dp, pm, s, c),
        memsys.map_state(lambda x: x[None], eager.final_state), n)
    out["d"]["pool_bytes"], out["d"]["buffer_bytes"] = \
        replay_entry_bytes(torch)
    if replay.GRAPHS.captures != captures:
        raise AssertionError("(d): the step past the trace captured anew")
    log(f"[replay] (d) run_trace mask, {CHURN_SEGMENTS} x {CHURN_SEG} "
        f"cycles, {CHURN_SLOTS} slots, {len(plan.faults)} faults, audit on: "
        f"graphed == eager float-hex (every snapshot, the final state); "
        f"{out['d']['graphed_ms']:.3f} against {out['d']['eager_ms']:.3f} "
        f"ms a cycle with the boundaries and snapshots; Python launches a "
        f"cycle {out['d']['graphed_launches']:.1f} against "
        f"{out['d']['eager_launches']:.1f} ({calls}); pool "
        f"{out['d']['pool_bytes']} B, buffers {out['d']['buffer_bytes']} B "
        f"[{card}]")
    # (e) sweep2-paper35's pass: 35 pairs and 25 solo rows, one design
    pairs = pair_workloads(7, 35)
    used = {b for m in pairs for b in m}
    rows = pairs + [(b, None) for b in sorted(used)]
    cfg = SimConfig(n_apps=2, design="mask", sim_cycles=REPLAY_CYCLES,
                    device="cuda")
    out["e"] = replay_case(torch, card, "(e) sweep2-paper35's 60-row pass",
                           cfg, design_params(cfg.design), pm_of(rows))
    return out


# ---- phase 22: flash with q/k and v of two widths (latent attention) ------
MLA_SCALE = 0.114721                  # deepseek-v2-lite's (192^-1/2 mscale^2)
# (S, H, KV, causal, window, v_pad): the <192, 128> instance (ragged S,
# bidirectional, GQA with a window), the last with v read from rows of
# 128 + 1 columns, an unaligned layout, so staged at the same widths
MLA_FLASH = [(1000, 16, 16, True, None, 0),
             (512, 16, 16, False, None, 0),
             (300, 8, 2, True, 90, 0),
             (256, 4, 4, True, None, 1)]
# (dqk, dv, dtype): pairs of unequal widths no instance takes, refused
MLA_REFUSED = [(160, 128, "bfloat16"), (192, 64, "bfloat16"),
               (192, 100, "bfloat16"), (128, 64, "bfloat16"),
               (192, 128, "float32")]
MLA_FLASH_TIMED = [(1, 32768), (2, 16384)]     # the cell's shapes, H = 16
MLA_ROWS = 256                        # query rows a block of the full check


def mla_inputs(torch, np, S, H, KV, dqk, dv, dtype, seed, B=2, v_pad=0):
    """q, k (B, heads, S, dqk) and v (B, KV, S, dv) views of (B, S, heads,
    d) normals on the card, as the model passes them; v's rows `v_pad`
    columns wider than dv where asked."""
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    q, k, v = [torch.tensor(rng.randn(B, S, n, d), dtype=torch.float32,
                            device="cuda").to(dt)
               for n, d in ((H, dqk), (KV, dqk), (KV, dv))]
    if v_pad:
        v = torch.zeros(B, S, KV, dv + v_pad, dtype=dt,
                        device="cuda")[..., :dv].copy_(v)
    return [t.transpose(1, 2) for t in (q, k, v)]


def full_check(torch, o, q, k, v, scale, rows):
    """The kernel's output `o` (B, H, S, dv) on every query row against
    the plain arithmetic (fp32 scores and softmax, p rounded to bf16), by
    `flash_compare`'s rounding bound, `rows` query rows at a time against
    the keys they see (the whole plain version at S = 32,768 would hold
    68 GB of scores). The products run on TF32 tensor cores: q, k, v and
    the rounded p are bf16 values, exact in TF32, so those products are
    the plain version's; the spread's squares are not (2^-11 relative
    each), so the spread is taken times 1 - 2^-9, which keeps the bound
    from widening. Returns (max |difference|, its largest share of the
    bound)."""
    S = q.shape[2]
    pos = torch.arange(S, device=q.device)
    err_max = share_max = 0.0
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for a in range(0, S, rows):
            b = min(a + rows, S)
            vb = v[:, :, :b].float()
            s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, a:b].float(),
                             k[:, :, :b].float()) * scale
            p = torch.softmax(s.masked_fill_(pos[None, :b] > pos[a:b, None],
                                             -1e30), dim=-1)
            del s
            want = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), vb)
            spread = torch.einsum("bhqk,bhkd->bhqd", p.square_(),
                                  vb.square_()).sqrt_() * (1 - 2.0 ** -9)
            del p, vb
            err = (o[:, :, a:b].float() - want).abs()
            limit = 2.0 ** -7 * (want.abs() + 4 * spread)
            err_max = max(err_max, float(err.max()))
            share_max = max(share_max, float((err / limit).max()))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if share_max > 1:
        raise AssertionError(f"flash <192, 128> != plain version at S = {S}:"
                             f" {share_max:.3g}x the rounding bound")
    return err_max, share_max


def mla_flash_phase(torch, np, card, kernel):
    """Phase 22: `flash_attention_bhsd` with v narrower than q and k and a
    given scale (latent attention) against the plain version through the
    instance <192, 128> (one call staged at its widths), the pairs no
    instance takes refused before a launch; then at the cell's shapes its
    time, bound and `scaled_dot_product_attention`'s, every query row
    against the plain arithmetic and SDPA's output beside it. Returns the
    entry of the JSON line."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.ref import attention_ref
    t0 = time.perf_counter()
    zero_counts(kernel)
    kernel.staged = 0
    errs, shares = [], []
    for S, H, KV, causal, window, v_pad in MLA_FLASH:
        q, k, v = mla_inputs(torch, np, S, H, KV, 192, 128, "bfloat16",
                             S + 128, v_pad=v_pad)
        err, share, _ = flash_compare(
            torch, kernel, attention_ref, q, k, v, causal, window,
            FLASH_TOL["bfloat16"], rounding=True, block_q=S, block_k=S,
            scale=MLA_SCALE)
        errs.append(err)
        shares.append(share)
    want_staged = sum(1 for case in MLA_FLASH if case[-1])
    routed(kernel, "wgmma", len(MLA_FLASH), "two-width cases")
    if kernel.staged != want_staged:
        raise AssertionError(f"flash two widths: {kernel.staged} staged, "
                             f"want {want_staged}")
    zero_counts(kernel)
    for dqk, dv, dtype in MLA_REFUSED:
        q, k, v = mla_inputs(torch, np, 256, 4, 4, dqk, dv, dtype, 3)
        try:
            kernel(q, k, v, causal=True, scale=MLA_SCALE)
        except ValueError as e:
            if "instance takes" not in str(e):
                raise
        else:
            raise AssertionError(f"flash took q/k {dqk} and v {dv} {dtype}")
    routed(kernel, "wgmma", 0, "refused pairs")
    log(f"[mla flash] kernel == plain version on {len(MLA_FLASH)} bf16 "
        f"<192, 128> cases ({want_staged} staged; largest share "
        f"{max(shares):.3g} of the rounding bound, max |err| "
        f"{max(errs):.3g}); {len(MLA_REFUSED)} other pairs refused before "
        f"a launch [{card}]")
    timed = []
    for B, S in MLA_FLASH_TIMED:
        H = 16
        q, k, v = mla_inputs(torch, np, S, H, H, 192, 128, "bfloat16", 0,
                             B=B)
        zero_counts(kernel)
        staged = kernel.staged
        run = lambda: kernel(q, k, v, causal=True, scale=MLA_SCALE)  # noqa
        o = run()
        routed(kernel, "wgmma", 1, f"B={B} S={S}")
        if kernel.staged != staged:
            raise AssertionError("the cell's shape was staged")
        err, share = full_check(torch, o, q, k, v, MLA_SCALE, MLA_ROWS)
        ms = time_events(torch, run, 5, 1)
        flops = 2 * (192 + 128) * B * H * visible_pairs(np, S, S, True, None)
        nbytes = 2 * (2 * q.numel() + 2 * v.numel())
        bound_ms = max(flops / BF16_TENSOR_FLOPS, nbytes / HBM_BYTES_PER_S) \
            * 1e3
        qc, kc, vc = (t.contiguous() for t in (q, k, v))
        lib_ms = lib_err = None
        try:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qc, kc, vc, is_causal=True, scale=MLA_SCALE)
            with torch.nn.attention.sdpa_kernel([
                    torch.nn.attention.SDPBackend.FLASH_ATTENTION,
                    torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION,
                    torch.nn.attention.SDPBackend.CUDNN_ATTENTION]):
                ref_o = lib()
                lib_ms = time_events(torch, lib, 5, 1)
            lib_err = float((ref_o.float() - o.float()).abs().max())
            del ref_o
        except RuntimeError as e:      # no fused SDPA backend takes it
            log(f"[mla flash] scaled_dot_product_attention refused: "
                f"{str(e).splitlines()[0][:200]}")
        timed.append(dict(B=B, S=S, H=H, ms=ms, bound_ms=bound_ms,
                          bound_share=bound_ms / ms,
                          tflops=flops / ms / 1e9, library_ms=lib_ms,
                          library_max_abs_diff=lib_err, max_abs_err=err,
                          bound_share_of_err=share))
        log(f"[mla flash] B={B} S={S} H=16 q/k 192 v 128 causal bf16 "
            f"(<192, 128>): {ms:.3f} ms on the device, {flops / ms / 1e9:.1f}"
            f" TFLOP/s, {bound_ms / ms:.3f} of the bound {bound_ms:.3f} ms "
            f"by operations ({flops:.4g} flop); every row: max "
            f"|err| {err:.3g}, {share:.3g}x the rounding bound; "
            f"scaled_dot_product_attention {lib_ms} ms, max |diff| "
            f"{lib_err} [{card}]")
        del q, k, v, o, qc, kc, vc
        torch.cuda.empty_cache()
    log(f"[mla flash] phase 22 took {time.perf_counter() - t0:.1f} s "
        f"[{card}]")
    return dict(name="flash_attention_qk192_v128", route="cuda",
                kernel="wgmma", source=FLASH_SOURCES["wgmma"],
                replaces="none: latent attention's v is narrower than q, k",
                launches=len(MLA_FLASH) + len(MLA_FLASH_TIMED),
                max_abs_err=max(errs), cases=len(MLA_FLASH),
                refused=len(MLA_REFUSED),
                timed=timed)


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.configs import get_model
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
    from repro_torch.kernels.fused_tlb.kernel import fused_tlb_round
    from repro_torch.kernels.fused_tlb.ref import fused_tlb_access_ref
    from repro_torch.kernels.paged_attention.kernel import paged_attention
    from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
    from repro_torch.sim import runner

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    names = ("fused_tlb", "flash_attention_sm90", "flash_attention",
             "ssd_scan", "paged_attention")
    with ThreadPoolExecutor(len(names)) as pool:    # one nvcc per source
        list(pool.map(_build.load, names))
    for name in names:
        log(f"[build] {name}.cu -> {_build.library_path(name).name}")
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log(f"[build] ptxas: {line.strip()}")
    log(f"[build] {len(names)} sources in {time.perf_counter() - t0:.2f} s")
    staging = (flash_attention_bhsd, paged_attention, ssd_intra_chunk)
    for kernel in staging:            # phases 2-19 stage nothing
        kernel.staged = 0

    # ---- 2. kernel against its plain version ----------------------------
    cases = []
    for shape in (L2_SHAPE, L2_IDEAL_SHAPE, PWC_SHAPE):
        for masks in ("all", "half", "nofill"):
            cases.append(path_case(np, *shape, masks, seed=sum(shape)))
    for shape in KERNEL_TEST_SHAPES:
        for track in (True, False):
            cases.append(kernel_test_case(np, *shape, track))
    cases += [collision_case(np, [8, 100]), collision_case(np, [100, 8])]
    max_err = max(compare(torch, fused_tlb_round, fused_tlb_access_ref, c)
                  for c in cases)
    log(f"[kernel] fused_tlb == plain version on {len(cases)} cases "
        f"(max |err| {max_err}) [{card}]")
    timings = []
    for label, shape in (("L2", L2_SHAPE), ("PWC", PWC_SHAPE)):
        case = path_case(np, *shape, "half", seed=1)
        ms = time_round_graph(torch, fused_tlb_round, case, 200)
        floor = launch_floor_graph(torch, 200)
        launch = time_round(torch, fused_tlb_round, case, 500)
        plain = time_round(torch, fused_tlb_access_ref, case, 50)
        args, kw = on_card(torch, case)
        out = fused_tlb_access_ref(*args, case["time"], **kw)
        least, bound_by = bound(np, case, [t.cpu().numpy() for t in out])
        timings.append(dict(round=label, sets=shape[0], ways=shape[1],
                            lanes=shape[2], waves=shape[3], ms=ms,
                            launch_floor_ms=floor, launch_ms=launch,
                            plain_ms=plain, bound_ms=least,
                            bound_by=bound_by))
        log(f"[kernel] {label} round {shape[0]}x{shape[1]}, N={shape[2]}, "
            f"W={shape[3]}: kernel {ms * 1e3:.2f} us on the device (graph "
            f"replay) beside a launch floor of {floor * 1e3:.2f} us (a "
            f"captured x.add_(1) on one element, replayed the same way), "
            f"{launch * 1e3:.2f} us per launch from Python; plain version "
            f"{plain * 1e3:.2f} us per call; bound {least * 1e3:.4f} us by "
            f"{bound_by} [{card}]")

    # ---- 3. the main path on the card: all goldens ----------------------
    fused_tlb_round.launches = 0
    rounds = 0
    seconds = {}
    for entry in sorted(GOLDEN):
        name, _, cyc = entry.partition("@")
        cycles = int(cyc) if cyc else 1200
        t0 = time.perf_counter()
        s = runner.run_mix(name, ["3DS", "BLK"], cycles=cycles,
                           device="cuda")
        seconds[entry] = time.perf_counter() - t0
        rounds += cycles * (2 if name == "pwc" else 1)
        for key, want in GOLDEN[entry].items():
            got = [x.hex() for x in
                   np.asarray(s[key], np.float64).ravel().tolist()]
            if got != want:
                raise AssertionError(f"{entry}:{key} {got} != {want}")
    launches = fused_tlb_round.launches
    if launches != rounds or launches == 0:
        raise AssertionError(f"fused_tlb launched {launches} times for "
                             f"{rounds} fused rounds")
    log(f"[path] 9 goldens reproduce float-hex on the card; fused_tlb "
        f"launches {launches} == rounds {rounds}; "
        f"{sum(seconds.values()):.1f} s [{card}]")

    def same(a, b, what):
        for k in a:
            if not np.array_equal(np.asarray(a[k]), np.asarray(b[k])):
                raise AssertionError(f"{what}: {k} differs")
    same(runner.run_mix("mask", ["3DS", "BLK"], 300, device="cuda"),
         runner.run_pair("mask", "3DS", "BLK", 300, device="cuda"),
         "run_mix vs run_pair")
    same(runner.run_mix("gpu-mmu", ["3DS", None], 300, device="cuda"),
         runner.run_solo("gpu-mmu", "3DS", 300, device="cuda"),
         "idle partner vs run_solo")
    log("[path] run_mix == run_pair, idle partner == run_solo (bitwise)")

    # ---- 4. timed run: the mask@9000 golden run of phase 3 --------------
    dt = seconds["mask@9000"]
    log(f"[timed] run_mix mask 3DS+BLK 9000 cycles: {dt:.2f} s, "
        f"{9000 / dt:.1f} simulated cycles/s [{card}]")

    # ---- 12. the grid layer on the same build ---------------------------
    t0 = time.perf_counter()
    grid = grid_phase(torch, np, card, fused_tlb_round, fused_tlb_access_ref,
                      9000 / dt)
    log(f"[grid] phase 12 took {time.perf_counter() - t0:.1f} s")

    # ---- 13. the churn runner on the same build --------------------------
    t0 = time.perf_counter()
    churn = churn_phase(torch, np, card, fused_tlb_round,
                        1200 / seconds["mask"])
    log(f"[churn] phase 13 took {time.perf_counter() - t0:.1f} s")

    # ---- 5-7. the model's serving path and its kernel -------------------
    flash, flash_fp32 = flash_phase(torch, np, flash_attention_bhsd, card)
    n_attn = get_model(SERVE_ARCH).n_layers
    zero_counts(flash_attention_bhsd)
    serve_logits = serve_phase(torch, np, card)
    flash["launches"] = flash_attention_bhsd.route_launches["wgmma"]
    routed(flash_attention_bhsd, "wgmma", n_attn * 2,
           f"2 bf16 prefills of {n_attn} layers")
    log(f"[serve] flash launches {flash['launches']} == {n_attn} x 2 "
        f"prefills, all on the wgmma route")
    zero_counts(flash_attention_bhsd)
    match_phase(torch, np, card)
    flash_fp32["launches"] = \
        flash_attention_bhsd.route_launches["split_tf32"]
    routed(flash_attention_bhsd, "split_tf32", n_attn * 2,
           f"fp32 forward_train + forward_prefill of {n_attn} layers")
    log(f"[match] flash launches {flash_fp32['launches']} == {n_attn} x 2 "
        f"(forward_train, forward_prefill), all on the split_tf32 route")

    # ---- 8-10. the Mamba2 serving path and its kernel -------------------
    ssd = ssd_phase(torch, np, card)
    n_ssm = get_model(MAMBA_ARCH).n_layers
    ssd_intra_chunk.launches = 0
    serve_phase(torch, np, card, MAMBA_ARCH, "mamba2")
    ssd["launches"] = ssd_intra_chunk.launches
    if ssd["launches"] != n_ssm * 2:
        raise AssertionError(f"ssd_intra_chunk launched {ssd['launches']} "
                             f"times in 2 prefills of {n_ssm} layers")
    log(f"[mamba2] ssd_intra_chunk launches {ssd['launches']} == {n_ssm} x "
        f"2 prefills")
    match_phase(torch, np, card, MAMBA_ARCH, "m-match")

    # ---- 11. the paged KV pool and its kernel ---------------------------
    paged = paged_phase(torch, np, card)

    # ---- 14. the serving stack on the same builds -----------------------
    t0 = time.perf_counter()
    overload = overload_phase(torch, np, card, fused_tlb_round)
    engine = engine_phase(torch, np, card, flash_attention_bhsd,
                          fused_tlb_round)
    launcher_s = launcher_phase(card)
    engine.update(engine_moe_phase(torch, np, card, flash_attention_bhsd))
    engine["launchers_s"] = {args[1]: launcher_phase(card, args, "(e)")
                             for args in LAUNCHERS}
    log(f"[serve-stack] phase 14 took {time.perf_counter() - t0:.1f} s")

    # ---- 15-16. the remaining model families -----------------------------
    t0 = time.perf_counter()
    moe = moe_phase(torch, np, card, flash_attention_bhsd)
    log(f"[moe] phase 15 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    families = families_phase(torch, np, card, flash_attention_bhsd,
                              ssd_intra_chunk)
    families["int8"] = int8_phase(torch, np, card, flash_attention_bhsd)
    log(f"[families] phase 16 took {time.perf_counter() - t0:.1f} s")
    flash["families"] = dict(
        {k: v for k, v in families.items() if k in ("phi", "whisper",
                                                    "mixtral", "jamba")},
        olmoe=moe)
    flash_fp32["families"] = {"olmoe_match": MOE_MATCH_LAYERS * 2,
                              "mixtral_match": MIXTRAL_LAYERS * 2}
    ssd["jamba"] = dict(launches=families["jamba"]["ssd_launches"],
                        per_prefill=families["jamba"]["ssd_launches"])

    # ---- 17. training ------------------------------------------------------
    t0 = time.perf_counter()
    ssd_backward = ssd_grad_phase(torch, card)
    grads = train_grad_phase(torch, np, card)
    trained = train_phase(torch, np, card)
    launched = train_launcher_phase(card)
    ssd["train"] = dict(trained, backward=ssd_backward, parity=grads,
                        launcher=launched)
    for entry in (flash, flash_fp32):
        entry["grad"] = "refused (NotImplementedError), as the reference"
    log(f"[train] phase 17 took {time.perf_counter() - t0:.1f} s")

    # ---- 18. the distributed layer ----------------------------------------
    t0 = time.perf_counter()
    dist_grid = sharded_grid_phase(torch, np, card, fused_tlb_round)
    ssd["distributed"] = sharded_train_phase(torch, np, card)
    flash["distributed"] = sharded_prefill_phase(
        torch, np, card, flash_attention_bhsd, serve_logits)
    log(f"[dist] phase 18 took {time.perf_counter() - t0:.1f} s")

    # ---- 19. the dry run ----------------------------------------------------
    t0 = time.perf_counter()
    ssd["dryrun"] = dryrun_route_phase(torch, card, ssd_intra_chunk)
    flash["dryrun"] = dryrun_tracker_phase(torch, np, card,
                                           flash_attention_bhsd)
    flash["dryrun"]["cli"] = dryrun_cli_phase(card)
    log(f"[dryrun] phase 19 took {time.perf_counter() - t0:.1f} s [{card}]")
    staged = {k.__name__: k.staged for k in staging}
    if any(staged.values()):
        raise AssertionError(f"phases 2-19 staged calls: {staged}")
    log(f"[smoke] staged calls over phases 2-19 (every model path): "
        f"{staged}")

    # ---- 20. the kernels' contracts ---------------------------------------
    contracts = contracts_phase(torch, np, card, fused_tlb_round,
                                fused_tlb_access_ref, flash_attention_bhsd)

    # ---- 21. the step's CUDA graphs -------------------------------------
    t0 = time.perf_counter()
    graphs = replay_phase(torch, np, card, fused_tlb_round)
    log(f"[replay] phase 21 took {time.perf_counter() - t0:.1f} s [{card}]")

    # ---- 22. flash with two head widths ---------------------------------
    contracts.append(mla_flash_phase(torch, np, card, flash_attention_bhsd))

    log(f"[smoke] every phase passed in {time.perf_counter() - t_start:.1f}"
        f" s [{card}]")
    l2 = timings[0]
    print(json.dumps({"kernels": [{
        "name": "fused_tlb", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tlb.cu",
        "replaces": "src/repro/kernels/fused_tlb/kernel.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": l2["ms"], "launch_floor_ms": l2["launch_floor_ms"],
        "launch_ms": l2["launch_ms"],
        "plain_ms": l2["plain_ms"],
        "bound_ms": l2["bound_ms"], "bound_by": l2["bound_by"],
        "library_ms": None, "shapes": timings, **grid, "churn": churn,
        "distributed": dist_grid, "step_graphs": graphs,
        "serving": dict(overload, engine_launches=engine[
            "engine_fused_tlb_launches"], engine_grid_calls=engine[
            "engine_grid_calls"])},
        dict(flash, serving=dict(engine, launcher_s=launcher_s),
             int8=families["int8"]),
        flash_fp32,
        ssd,
        paged] + contracts}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
