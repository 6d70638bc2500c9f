"""Training loop: train step + checkpoint/restart + straggler policy.

Port of `repro.train.loop`. The step runs eagerly on `device` (None means
the card, and raises without one); each batch is made on the host by the
data pipeline and moved to the device here.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.fault_tolerance import (
    BoundedDispatcher, StragglerPolicy, resume_or_init)
from repro_torch.models import model as M
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.step import build_train_step


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0
    opt: opt_mod.OptConfig = dataclasses.field(
        default_factory=opt_mod.OptConfig)


def train(cfg: ModelConfig, run: RunConfig, tcfg: TrainConfig,
          constrain=None, log: Callable[[str], None] = print, *,
          device: DeviceLike = None,
          init_fn: Optional[Callable[[], Tuple]] = None) -> Dict:
    """Single-device loop. Returns {"params", "opt_state", "history"}.

    `init_fn() -> (params, opt_state)` makes the fresh state; by default
    the params are drawn from `torch.Generator(device).manual_seed(
    tcfg.seed)` through `models.model.init_params`."""
    dev = resolve_device(device)
    step_fn = build_train_step(cfg, run, tcfg.opt, constrain)
    pipe = DataPipeline(cfg, run.shape, DataConfig(seed=tcfg.seed))
    straggler = StragglerPolicy()
    dispatcher = BoundedDispatcher()

    if init_fn is None:
        def init_fn():
            gen = torch.Generator(dev).manual_seed(tcfg.seed)
            params = M.init_params(gen, cfg, device=dev)
            return params, opt_mod.init(params, tcfg.opt)

    ckpt = Checkpointer(tcfg.ckpt_dir) if tcfg.ckpt_dir else None
    if ckpt:
        params, opt_state, start = resume_or_init(ckpt, init_fn)
    else:
        params, opt_state = init_fn()
        start = 0

    history = []
    for step, batch in pipe.iterate(start, tcfg.steps):
        tb = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        t0 = time.time()
        params, opt_state, metrics = step_fn(params, opt_state, tb)
        dispatcher.dispatch(metrics)
        dt = time.time() - t0
        if straggler.record(dt):
            log(f"[straggler] step {step} took {dt:.2f}s "
                f"(median {straggler.median():.2f}s)")
        if step % tcfg.log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            history.append({"step": step, **m})
            log(f"step {step}: loss={m.get('loss', float('nan')):.4f}")
        if ckpt and step > start and step % tcfg.ckpt_every == 0:
            dispatcher.drain()
            ckpt.save(step, params, opt_state,
                      extra={"next_step": step + 1}, blocking=False)
    dispatcher.drain()
    if ckpt:
        ckpt.save(tcfg.steps, params, opt_state,
                  extra={"next_step": tcfg.steps}, blocking=True)
    return {"params": params, "opt_state": opt_state, "history": history}
