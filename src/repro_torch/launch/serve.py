"""Serving launcher: multi-tenant continuous batching on the reduced config
(port of `repro.launch.serve`, with the same flags and a `--device`).

Ad-hoc requests:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --tenants 2 --requests 8

Trace-driven with a placement policy (serving.stream presets; the
"oracle" policy consults the simulator-backed contention oracle and
walks the overload degradation ladder — quota -> preempt -> freeze ->
safe mode — under KV-pool pressure):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --trace flood_vs_trickle --steps 24 --policy oracle

Overload drills inject a seeded serving-fault plan (pool-exhaustion
spikes, oracle stalls, poisoned profiles — sim.faults):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
      --trace flood_vs_trickle --policy oracle --faults --fault-rate 0.1

The engine, its model and the oracle's simulator run on `--device`
(default: the card; it raises without one). `--device cpu` runs on the
CPU.
"""
from __future__ import annotations

import argparse
from typing import Mapping, Optional

import numpy as np
import torch

from repro_torch.configs import get_model, reduced_model
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.memmgr.kv_cache import PoolConfig
from repro_torch.models import model as M
from repro_torch.serving import metrics as smet
from repro_torch.serving import stream as strm
from repro_torch.serving.engine import EngineConfig, Request, ServingEngine
from repro_torch.serving.placement import POLICIES, make_policy
from repro_torch.sim.faults import random_serving_plan


def build_engine(arch: str, max_seqs: int = 16, policy: str = "none",
                 profiles: Optional[Mapping[int, str]] = None,
                 epoch_steps: int = 8, ecfg: Optional[EngineConfig] = None,
                 device: DeviceLike = None, **policy_kw) -> ServingEngine:
    """Engine on the reduced model, with random params from a generator
    seeded 0, on `device` (None means the card, and raises without one).
    `policy`/`profiles` select the admission placement layer
    (serving.placement); extra kwargs reach the policy factory (e.g.
    cycles=..., unfairness_cap=... for "oracle", whose oracle runs on the
    engine's device)."""
    dev = resolve_device(device)
    cfg = reduced_model(get_model(arch))
    shape = ShapeConfig("serve", seq_len=64, global_batch=1, kind="decode")
    run = RunConfig(model=cfg, shape=shape, remat=False,
                    attn_block_q=16, attn_block_k=16)
    params = M.init_params(torch.Generator(device=dev).manual_seed(0), cfg,
                           device=dev)
    n_attn = sum(1 for k in cfg.layer_kinds() if k == "attn")
    pool = PoolConfig(
        n_pages=max_seqs * 8, page_size=cfg.kv_page_size,
        n_kv=max(cfg.n_kv_heads, 1), head_dim=cfg.head_dim if cfg.n_heads else 1,
        n_layers=max(n_attn, 1), max_seqs=max_seqs, pages_per_seq=8)
    if policy == "oracle":
        policy_kw.setdefault("device", dev)
    placement = make_policy(policy, profiles=profiles,
                            epoch_steps=epoch_steps, **policy_kw)
    return ServingEngine(cfg, run, params, pool,
                         ecfg or EngineConfig(),
                         placement=placement, profiles=profiles, device=dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--policy", default="none", choices=POLICIES)
    ap.add_argument("--trace", default=None,
                    help=f"trace preset {sorted(strm.PRESETS)}; omit for "
                         "ad-hoc --requests mode")
    ap.add_argument("--steps", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epoch-steps", type=int, default=8)
    ap.add_argument("--cycles", type=int, default=300,
                    help="oracle: simulator cycles per prediction")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="decode slots per engine step")
    ap.add_argument("--max-running", type=int, default=None,
                    help="admission bound (> max-batch gives decode "
                         "quotas/preemption a lever; default: coupled)")
    ap.add_argument("--faults", action="store_true",
                    help="inject a seeded random serving-fault plan "
                         "(pool spikes, oracle stalls, poisoned profiles)")
    ap.add_argument("--fault-rate", type=float, default=0.05)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card, 'cuda')")
    args = ap.parse_args()

    ecfg = EngineConfig(max_batch=args.max_batch,
                        max_running=args.max_running,
                        backoff_seed=args.seed)
    if args.trace:
        trace = strm.make_trace(args.trace, seed=args.seed,
                                steps=args.steps)
        if args.faults:
            ecfg.fault_plan = random_serving_plan(
                args.seed, trace.steps,
                tuple(s.tenant for s in trace.specs),
                rate=args.fault_rate)
        kw = {"cycles": args.cycles} if args.policy == "oracle" else {}
        eng = build_engine(args.arch, policy=args.policy,
                           profiles=trace.profiles(),
                           epoch_steps=args.epoch_steps, ecfg=ecfg,
                           device=args.device, **kw)
        finished = strm.drive(eng, trace)
    else:
        eng = build_engine(args.arch, policy=args.policy, ecfg=ecfg,
                           profiles={t: "batch"
                                     for t in range(args.tenants)},
                           device=args.device)
        rng = np.random.RandomState(args.seed)
        for i in range(args.requests):
            eng.submit(Request(
                rid=i, tenant=i % args.tenants,
                prompt=rng.randint(0, eng.cfg.vocab_size, args.prompt_len),
                max_new=args.max_new))
        finished = eng.run_until_drained()

    tput = smet.tenant_throughput(finished, eng.step_count)
    print(f"policy={args.policy}: finished {len(finished)} requests "
          f"in {eng.step_count} steps "
          f"({len(eng.decisions)} placement decisions) on {eng.device}")
    for t, v in sorted(tput.items()):
        print(f"  tenant {t}: {v:.2f} tok/step")
    print(f"mean latency {smet.mean_latency(finished):.1f} steps")
    cons = smet.conservation_report(eng)
    print(f"conservation: submitted {cons['submitted']} "
          f"finished {cons['finished']} lost {cons['lost']} "
          f"duplicated {cons['duplicated']}")
    if eng.decisions:
        summ = smet.decision_summary(eng.decisions)
        print(f"ladder rungs: {summ['rungs']}")
        if summ["predicted_max_slowdown_mean"] is not None:
            print(f"oracle predicted max slowdown (mean over epochs): "
                  f"{summ['predicted_max_slowdown_mean']:.3f}")
    if eng.preemptions or eng.fault_log:
        over = smet.overload_summary(eng)
        print(f"preemptions {over['preemptions']} "
              f"wasted tokens {over['wasted_tokens']} "
              f"faults {over['faults_injected']} "
              f"safe-mode log {over['safe_mode_log']}")


if __name__ == "__main__":
    main()
