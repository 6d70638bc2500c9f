"""Time the ssd and flash kernels through the Python wrappers of two
checkouts on one card, to tell a wrapper's cost from the kernel's.

    python3 scripts/torch_wrapper_ab.py <checkout A> <checkout B> [rounds]

Each checkout runs in its own process (both packages are `repro_torch`),
in the order A, B, B, A, repeated `rounds` times (default 2); each builds
its own kernels under its `build/`. A process times `ssd_intra_chunk` at
the mamba2-1.3b serving shape (B=4, 8 chunks of 256, 64 heads of 64,
d_state 128, fp32) and `flash_attention_bhsd` at qwen3-4b's (B=4, S=2048,
32 heads, 8 KV heads, dh 128, bf16, causal): the device ms a launch (CUDA
events around 20 launches, 5 times) and the ms a launch from Python
(synchronised, 10 launches, 5 times). It prints one line per process and,
last, a JSON object of every reading.
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
from repro_torch.kernels.ssd_scan.kernel import ssd_intra_chunk
g = torch.Generator(device="cuda").manual_seed(0)
x = torch.randn(4, 8, 256, 64, 64, device="cuda", generator=g)
dA = -torch.rand(4, 8, 256, 64, device="cuda", generator=g) * 0.1
Bm = torch.randn(4, 8, 256, 128, device="cuda", generator=g)
Cm = torch.randn(4, 8, 256, 128, device="cuda", generator=g)
q = torch.randn(4, 32, 2048, 128, device="cuda", generator=g).bfloat16()
k = torch.randn(4, 8, 2048, 128, device="cuda", generator=g).bfloat16()
v = torch.randn(4, 8, 2048, 128, device="cuda", generator=g).bfloat16()
out = {}
for name, run in (("ssd", lambda: ssd_intra_chunk(x, dA, Bm, Cm)),
                  ("flash", lambda: flash_attention_bhsd(q, k, v))):
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    dev, host = [], []
    for _ in range(5):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(20):
            run()
        e.record()
        torch.cuda.synchronize()
        dev.append(s.elapsed_time(e) / 20)
        t = time.perf_counter()
        for _ in range(10):
            run()
            torch.cuda.synchronize()
        host.append((time.perf_counter() - t) / 10 * 1e3)
    out[name] = {"device_ms": dev, "launch_ms": host}
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
