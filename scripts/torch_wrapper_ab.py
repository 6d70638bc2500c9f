"""Time the port's kernels through the Python wrappers of two checkouts
on one card, at the shapes the main path gives them.

    python3 scripts/torch_wrapper_ab.py <checkout A> <checkout B> [rounds]

Each checkout runs in its own process (both packages are `repro_torch`),
in the order A, B, B, A, repeated `rounds` times (default 2); each builds
its own kernels under its `build/`. A process times, with seeded inputs:
  * `ssd_intra_chunk` at the mamba2-1.3b serving shape (B=4, 8 chunks of
    256, 64 heads of 64, d_state 128, fp32);
  * `flash_attention_bhsd` at qwen3-4b's prefill (B=4, S=2048, 32 heads,
    8 KV heads, dh 128, bf16, causal) and at its fp32 match (B=2, S=496,
    the same heads, fp32, causal);
  * `paged_attention` at the paged pool's shape (32 sequences of up to
    2048 tokens in pages of 128, 32 query heads over 8 KV heads of 128,
    bf16);
  * `fused_tlb_round` at the L2 round (1024 sets x 16 ways, 240 lanes in
    8 waves, tag-only), 200 rounds on one evolving table captured in a
    CUDA graph and replayed, as `chip_smoke.py`'s phase 2 times it.
For each: the device ms a launch (CUDA events around 20 launches, or 5
replays of the graph, 5 times) and the ms a launch from Python
(synchronised, 10 launches, 5 times). It prints one line per process
and, last, a JSON object of every reading.
"""
from __future__ import annotations

import json
import subprocess
import sys

_TIMER = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1] + "/src")
import torch
from repro_torch.kernels.flash_attention.kernel import flash_attention_bhsd
from repro_torch.kernels.fused_tlb.kernel import fused_tlb_round
from repro_torch.kernels.paged_attention.kernel import paged_attention
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
g = torch.Generator(device="cuda").manual_seed(0)
dev = "cuda"
x = torch.randn(4, 8, 256, 64, 64, device=dev, generator=g)
dA = -torch.rand(4, 8, 256, 64, device=dev, generator=g) * 0.1
Bm = torch.randn(4, 8, 256, 128, device=dev, generator=g)
Cm = torch.randn(4, 8, 256, 128, device=dev, generator=g)
q = torch.randn(4, 32, 2048, 128, device=dev, generator=g).bfloat16()
k = torch.randn(4, 8, 2048, 128, device=dev, generator=g).bfloat16()
v = torch.randn(4, 8, 2048, 128, device=dev, generator=g).bfloat16()
qf, kf, vf = (torch.randn(2, n, 496, 128, device=dev, generator=g)
              for n in (32, 8, 8))
P = 32 * 16 + 4
pq = torch.randn(32, 32, 128, device=dev, generator=g).bfloat16()
kp = torch.randn(P, 128, 8, 128, device=dev, generator=g).bfloat16()
vp = torch.randn(P, 128, 8, 128, device=dev, generator=g).bfloat16()
bt = torch.randperm(P, device=dev, generator=g)[:32 * 16].view(32, 16) \
    .int()
sl = torch.randint(1, 2048, (32,), device=dev, generator=g).int()
tags = torch.randint(-2**21, 2**21, (1024, 16), device=dev, generator=g) \
    .int() * 1024 + torch.arange(1024, device=dev).int()[:, None]
asids = torch.zeros_like(tags)
lru = torch.randint(0, 3000, (1024, 16), device=dev, generator=g).int()
pick = tags.view(-1)[torch.randint(0, 1024 * 16, (240,), device=dev,
                                   generator=g)]
fresh = torch.randint(-2**21, 2**21, (240,), device=dev, generator=g).int() \
    * 1024 + torch.randint(0, 1024, (240,), device=dev, generator=g).int()
half = torch.rand(240, device=dev, generator=g) < 0.5
vpn = torch.where(half, pick, fresh)
asid = torch.zeros(240, dtype=torch.int32, device=dev)
active = torch.rand(240, device=dev, generator=g) < 0.5
may_fill = torch.rand(240, device=dev, generator=g) < 0.8
planes = [t.clone() for t in (tags, asids, lru)]


def tlb():                       # as chip_smoke.py's phase 2 times it
    fused_tlb_round(*planes, vpn, asid, active, may_fill, 3001, n_waves=8,
                    track_asids=False)


def graphed(fn, reps=200):
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
    return lambda: graph.replay(), reps


out = {}
for name, run in (
        ("ssd", lambda: ssd_intra_chunk(x, dA, Bm, Cm)),
        ("flash", lambda: flash_attention_bhsd(q, k, v)),
        ("flash_fp32", lambda: flash_attention_bhsd(qf, kf, vf)),
        ("paged", lambda: paged_attention(pq, kp, vp, bt, sl)),
        ("fused_tlb", tlb)):
    per = 20
    launch = run
    if name == "fused_tlb":
        run, per = graphed(launch)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    dev_ms, host = [], []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        reps = 20 if per == 20 else 5
        s.record()
        for _ in range(reps):
            run()
        e.record()
        torch.cuda.synchronize()
        dev_ms.append(s.elapsed_time(e) / (reps * (1 if per == 20 else per)))
        t = time.perf_counter()
        for _ in range(10):
            launch()
            torch.cuda.synchronize()
        host.append((time.perf_counter() - t) / 10 * 1e3)
    out[name] = {"device_ms": dev_ms, "launch_ms": host}
print(json.dumps(out))
"""


def main():
    a, b = sys.argv[1], sys.argv[2]
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    readings = []
    for side in ("A", "B", "B", "A") * rounds:
        root = a if side == "A" else b
        proc = subprocess.run([sys.executable, "-c", _TIMER, root],
                              capture_output=True, text=True, check=True)
        got = json.loads(proc.stdout.splitlines()[-1])
        readings.append({"side": side, "root": root, **got})
        print(side, " ".join(
            f"{n} device {' '.join(f'{t:.4f}' for t in r['device_ms'])} "
            f"launch {' '.join(f'{t:.4f}' for t in r['launch_ms'])};"
            for n, r in got.items()), flush=True)
    print(json.dumps(readings))


if __name__ == "__main__":
    main()
