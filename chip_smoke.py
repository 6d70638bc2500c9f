#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase's failure is caught):

  1. build  -- compile `src/repro_torch/csrc/fused_tlb.cu` for sm_90a;
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
               (the `mask@9000` golden of phase 3).

The line before the last is the card's name and power limit; the last
line is `{"ok": true, "device": {...}}`. Needs one CUDA device; exits
non-zero without one, and outside a checkout of the repository.
"""
import json
import subprocess
import sys
import time
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


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is visible")
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np

    from repro_torch.kernels import _build
    from repro_torch.kernels.fused_tlb.kernel import fused_tlb_round
    from repro_torch.kernels.fused_tlb.ref import fused_tlb_access_ref
    from repro_torch.sim import runner

    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.load("fused_tlb")
    log(f"[build] fused_tlb.cu -> {_build.library_path('fused_tlb').name} "
        f"in {time.perf_counter() - t0:.2f} s")
    report = _build.library_path("fused_tlb").with_suffix(".log")
    if report.exists():
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] ptxas: {line.strip()}")

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

    l2 = timings[0]
    print(json.dumps({"kernels": [{
        "name": "fused_tlb", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_tlb.cu",
        "replaces": "src/repro/kernels/fused_tlb/kernel.py:44",
        "launches": launches, "max_abs_err": max_err,
        "ms": l2["ms"], "launch_ms": l2["launch_ms"],
        "plain_ms": l2["plain_ms"],
        "bound_ms": l2["bound_ms"], "bound_by": l2["bound_by"],
        "library_ms": None, "shapes": timings}]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
