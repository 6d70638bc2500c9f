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
               kernel's device time (CUDA-graph replay), its time per
               launch from Python, and the plain version's time;
  3. path   -- the simulator's main path, `run_mix(..., device="cuda")`,
               on all 9 float-hex goldens of the reference; the kernel's
               launch count must equal the fused rounds the runs made;
               run_mix == run_pair and idle partner == run_solo;
  4. timed  -- simulated cycles per second of the 9000-cycle mask run
               (the `mask@9000` golden of phase 3);
  5. flash  -- the `flash_attention` kernels against their plain PyTorch
               version on the card, each check on the route its dtype
               selects (bf16: the tensor-core kernel
               `flash_attention_sm90.cu`; fp32: the SIMT kernel
               `flash_attention.cu`; the route counts are checked): the
               reference kernel test's 18 cases (atol = rtol = 2e-2 in
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
               same times of the SIMT kernel at phase 7's fp32 shape;
  6. serve  -- the model's serving path at full width: qwen3-4b (36
               layers) in bf16 with random weights from a seeded generator
               on the card, `attention_impl="pallas_flash"`; 4 prompts of
               2048 tokens through `forward_prefill` (max_len 2112), twice
               (cold, then timed), then 64 greedy `forward_decode` steps;
               flash launches == 36 per prefill, finite logits, cache_len
               2112 at the end; every flash launch on the wgmma route;
  7. match  -- the same model in fp32 (TF32 off for matmul and cuDNN):
               `forward_prefill` of 2 x 496 tokens plus 16 `forward_decode`
               steps against `forward_train` over the same 512 tokens
               (logits within 2e-3 after prefill, 5e-3 in decode); the
               72 flash launches (36 in each) all on the simt route;
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
               in both dtypes (atol = rtol = 2e-5 fp32, 3e-2 bf16); a q
               off 16-byte alignment refused; then a paged
               KV pool at qwen3-4b's serving
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

The line before the last is the card's name and power limit; the last
line is `{"ok": true, "device": {...}}`. Needs one CUDA device; exits
non-zero without one, and outside a checkout of the repository.
"""
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
                 "simt": "src/repro_torch/csrc/flash_attention.cu"}
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


def time_round_graph(torch, fn, case, reps):
    """Device ms per call: `reps` calls captured in one CUDA graph and
    replayed, so no host launch overhead is counted."""
    args, kw = on_card(torch, case)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args, case["time"], **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args, case["time"], **kw)
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


def bound(np, case, out):
    """Least time in ms for one round on these inputs, and what bounds it:
    the larger of its bytes over the HBM rate and its operations over the
    CUDA cores' rate. `out` is the round's result on this case (tags,
    asids, lru, hit, filled), as numpy arrays.

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
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def flash_inputs(torch, np, S, H, KV, dh, dtype, seed, B=2):
    """The reference test's inputs: numpy normals in (B, S, heads, dh), on
    the card in `dtype`, passed as (B, heads, S, dh) views as the model's
    `ops.flash_attention` passes them."""
    rng = np.random.RandomState(seed)
    dt = getattr(torch, dtype)
    return [torch.tensor(rng.randn(B, S, n, dh), dtype=torch.float32,
                         device="cuda").to(dt).transpose(1, 2)
            for n in (H, KV, KV)]


def rounding_spread(torch, q, k, v, causal, window):
    """sqrt(sum_j p_j^2 v_j^2) for each output element, p the fp32 softmax
    of the plain version: the spread of a sum of per-key rounding errors
    of p_j v_j."""
    B, H, Sq, dh = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs",
                     q.float().reshape(B, KV, H // KV, Sq, dh),
                     k.float()) / dh ** 0.5
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    hide = torch.zeros((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        hide |= kpos > qpos
    if window is not None:
        hide |= kpos <= qpos - window
    p = torch.softmax(s.masked_fill(hide, -1e30), dim=-1)
    return torch.einsum("bkgqs,bksd->bkgqd", p * p,
                        v.float() ** 2).sqrt().reshape(B, H, Sq, dh)


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
    of the limit, and the median |o|."""
    got = kernel(q, k, v, causal=causal, window=window, **blocks).float()
    want = ref(q, k, v, causal=causal, window=window).float()
    if rounding:
        limit = 2.0 ** -7 * (want.abs() + 4 * rounding_spread(
            torch, q, k, v, causal, window))
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


def flash_timing(torch, np, kernel, q, k, v, flop_rate):
    """The kernel's device time (CUDA events), its time per launch from
    Python, the plain version's time and `scaled_dot_product_attention`'s
    on causal q, k, v, with the bound: the larger of the visible pairs'
    flop over `flop_rate` and q, k, v, o's bytes over the HBM rate."""
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
    by_ops = flops / flop_rate * 1e3
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms, bound_by = (by_ops, "operations") if by_ops >= by_bytes \
        else (by_bytes, "bytes")
    return dict(ms=ms, launch_ms=launch_ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                flops=flops, nbytes=nbytes, tflops=flops / ms / 1e9,
                bound_share=bound_ms / ms)


def flash_phase(torch, np, kernel, card):
    """Phase 5: the flash kernels against their plain version, each on the
    route its dtype selects, and their times: the tensor-core kernel at the
    serving shape, the SIMT kernel at phase 7's fp32 shape. Returns the two
    entries of the JSON line (launches filled in by phases 6 and 7)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    errs = {"float32": [], "bfloat16": []}
    for dtype, kind in (("float32", "simt"), ("bfloat16", "wgmma")):
        zero_counts(kernel)
        for S, H, KV, dh, bq, bk in FLASH_SHAPES:
            q, k, v = flash_inputs(torch, np, S, H, KV, dh, dtype, S + H)
            for causal, window in FLASH_MASKS:
                errs[dtype].append(flash_compare(
                    torch, kernel, attention_ref, q, k, v, causal, window,
                    FLASH_TOL[dtype], block_q=bq, block_k=bk)[0])
        routed(kernel, kind, len(FLASH_SHAPES) * len(FLASH_MASKS),
               f"{dtype} sweep")
    log(f"[flash] kernel == plain version on the reference's "
        f"{sum(map(len, errs.values()))} sweep cases (max |err| "
        f"{max(errs['float32']):.3g} fp32 on the simt route, "
        f"{max(errs['bfloat16']):.3g} bf16 on the wgmma route) [{card}]")
    for dtype, kind in (("float32", "simt"), ("bfloat16", "wgmma")):
        zero_counts(kernel)                   # phase 7's ragged prefill
        q, k, v = flash_inputs(torch, np, MATCH_PROMPT, 32, 8, 128, dtype, 1,
                               B=MATCH_B)
        bf16 = dtype == "bfloat16"
        err, share, typical = flash_compare(
            torch, kernel, attention_ref, q, k, v, True, None,
            FLASH_TOL[dtype], bf16)
        routed(kernel, kind, 1, f"B={MATCH_B} S={MATCH_PROMPT} {dtype}")
        errs[dtype].append(err)
        log(f"[flash] B={MATCH_B} S={MATCH_PROMPT} causal {dtype} ({kind}): "
            f"max |err| {err:.3g}, {share:.3g}x "
            f"{'the rounding bound' if bf16 else 'tol'}; median |o| "
            f"{typical:.3g}")
    shares = {}
    for dtype, kind in (("float32", "simt"), ("bfloat16", "wgmma")):
        zero_counts(kernel)
        bf16 = dtype == "bfloat16"
        shares[dtype] = []
        for S, H, KV, dh, causal, window in FLASH_EDGES:
            q, k, v = flash_inputs(torch, np, S, H, KV, dh, dtype, S + dh)
            err, share, _ = flash_compare(
                torch, kernel, attention_ref, q, k, v, causal, window,
                FLASH_TOL[dtype], rounding=bf16, block_q=S, block_k=S)
            errs[dtype].append(err)
            shares[dtype].append(share)
        routed(kernel, kind, len(FLASH_EDGES), f"{dtype} edge cases")
    log(f"[flash] kernels == plain version on {len(FLASH_EDGES)} edge cases "
        f"each (ragged S, windows across tile edges, non-causal, G 1 to 8, "
        f"dh 32/64/96/128): wgmma within the rounding bound (largest share "
        f"{max(shares['bfloat16']):.3g}), simt within tol 2e-5 (largest "
        f"share {max(shares['float32']):.3g}) [{card}]")

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
    fp = flash_timing(torch, np, kernel, q, k, v, CUDA_CORE_OPS_PER_S)
    log(f"[flash] B={MATCH_B} S={MATCH_PROMPT} H=32 KV=8 dh=128 causal fp32 "
        f"(simt route, {FLASH_SOURCES['simt']}): kernel {fp['ms']:.4f} ms "
        f"on the device ({fp['tflops']:.2f} TFLOP/s, "
        f"{fp['bound_share']:.3f} of the bound), {fp['launch_ms']:.4f} ms "
        f"per launch from Python; plain version {fp['plain_ms']:.3f} ms; "
        f"scaled_dot_product_attention {fp['library_ms']:.4f} ms; bound "
        f"{fp['bound_ms']:.4f} ms by {fp['bound_by']} ({fp['flops']:.4g} "
        f"flop at the CUDA cores' fp32 rate, {fp['nbytes']:.4g} B) [{card}]")
    del q, k, v
    torch.cuda.empty_cache()
    entries = []
    for name, kind, dtype, t, shape in (
            ("flash_attention", "wgmma", "bfloat16", tc,
             {"B": B, "S": S, "H": H, "KV": KV, "dh": dh}),
            ("flash_attention_fp32", "simt", "float32", fp,
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


def model_setup(torch, dtype, arch=SERVE_ARCH):
    """`arch` (qwen3-4b) at full width on the card, seeded random weights
    in `dtype` (None: each leaf's own dtype, bf16 weights),
    `attention_impl="pallas_flash"`."""
    from repro_torch.configs import get_model
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.models import model
    cfg = get_model(arch)
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
    bf16."""
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


def match_phase(torch, np, card, arch=SERVE_ARCH, tag="match"):
    """Phases 7 and 10: prefill + decode == forward_train, full width,
    fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model, cfg, run, params = model_setup(torch, torch.float32, arch)
    rng = np.random.RandomState(1)
    tokens = torch.tensor(rng.randint(0, cfg.vocab_size, (MATCH_B, MATCH_S)),
                          dtype=torch.int32, device="cuda")
    full, _ = model.forward_train(cfg, run, params, {"tokens": tokens})
    logits, caches = model.forward_prefill(
        cfg, run, params, {"tokens": tokens[:, :MATCH_PROMPT]},
        max_len=MATCH_S)
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
        f"{MATCH_TOL_DECODE}); max |logit| {scale:.3g} [{card}]")
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
    q, kp, vp, bt, sl = paged_inputs(torch, np, 3, 8, 2, 64, 16, 6,
                                     "bfloat16")
    flat = torch.empty(q.numel() + 8, dtype=q.dtype, device="cuda")
    odd = flat[1:q.numel() + 1].view(q.shape).copy_(q)
    try:
        paged_attention(odd, kp, vp, bt, sl)
    except ValueError as e:
        log(f"[paged] a q 2 bytes off 16-byte alignment is refused: {e}")
    else:
        raise AssertionError("paged_attention took a misaligned q")

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


def main():
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
        launch = time_round(torch, fused_tlb_round, case, 500)
        plain = time_round(torch, fused_tlb_access_ref, case, 50)
        args, kw = on_card(torch, case)
        out = fused_tlb_access_ref(*args, case["time"], **kw)
        least, bound_by = bound(np, case, [t.cpu().numpy() for t in out])
        timings.append(dict(round=label, sets=shape[0], ways=shape[1],
                            lanes=shape[2], waves=shape[3], ms=ms,
                            launch_ms=launch, plain_ms=plain,
                            bound_ms=least, bound_by=bound_by))
        log(f"[kernel] {label} round {shape[0]}x{shape[1]}, N={shape[2]}, "
            f"W={shape[3]}: kernel {ms * 1e3:.2f} us on the device (graph "
            f"replay), {launch * 1e3:.2f} us per launch from Python; plain "
            f"version {plain * 1e3:.2f} us per call; bound "
            f"{least * 1e3:.4f} us by {bound_by} [{card}]")

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

    # ---- 5-7. the model's serving path and its kernel -------------------
    flash, flash_fp32 = flash_phase(torch, np, flash_attention_bhsd, card)
    n_attn = get_model(SERVE_ARCH).n_layers
    zero_counts(flash_attention_bhsd)
    serve_phase(torch, np, card)
    flash["launches"] = flash_attention_bhsd.route_launches["wgmma"]
    routed(flash_attention_bhsd, "wgmma", n_attn * 2,
           f"2 bf16 prefills of {n_attn} layers")
    log(f"[serve] flash launches {flash['launches']} == {n_attn} x 2 "
        f"prefills, all on the wgmma route")
    zero_counts(flash_attention_bhsd)
    match_phase(torch, np, card)
    flash_fp32["launches"] = flash_attention_bhsd.route_launches["simt"]
    routed(flash_attention_bhsd, "simt", n_attn * 2,
           f"fp32 forward_train + forward_prefill of {n_attn} layers")
    log(f"[match] flash launches {flash_fp32['launches']} == {n_attn} x 2 "
        f"(forward_train, forward_prefill), all on the simt route")

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

    l2 = timings[0]
    print(json.dumps({"kernels": [{
        "name": "fused_tlb", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tlb.cu",
        "replaces": "src/repro/kernels/fused_tlb/kernel.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": l2["ms"], "launch_ms": l2["launch_ms"],
        "plain_ms": l2["plain_ms"],
        "bound_ms": l2["bound_ms"], "bound_by": l2["bound_by"],
        "library_ms": None, "shapes": timings}, flash, flash_fp32, ssd,
        paged]}),
        flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
