"""Fault tolerance & elasticity for 1000+-node runs.

Port of `repro.distributed.fault_tolerance` (pure Python but for the
dispatcher's wait, which waits on CUDA events instead of JAX arrays).

Mechanisms:

* **Checkpoint/restart** — Checkpointer writes atomic COMMITTED snapshots;
  `resume_or_init` picks the newest valid one, discarding partials from a
  crashed run. The data pipeline is index-addressed, so restart is exact
  (deterministic skip-ahead, no replayed or skipped batches).

* **Elastic re-scale** — `elastic_remesh` re-lowers the same step function
  over a smaller/larger mesh from the same checkpoint; snapshots are
  topology-independent (host-gathered leaves, restored onto the template
  leaves' devices).
  Policy: drop the 'data' axis first (keeps TP intact), never below
  min_data.

* **Straggler mitigation** — `StragglerPolicy` tracks a robust step-time
  estimate (median + MAD); steps exceeding `threshold x median` mark the
  epoch as straggling. Remedies, in escalation order: (1) bounded in-flight
  dispatch (never queue more than `max_inflight` steps so one slow host
  cannot build unbounded skew), (2) within-step timeout -> raise
  StragglerAbort so the launcher checkpoints and re-meshes without the slow
  pod. On real fleets remedy (2) keys off collective timeouts; here it is
  driven by wall-clock.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.models.params import tree_leaves


class StragglerAbort(RuntimeError):
    pass


@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 3.0
    warmup_steps: int = 5
    max_inflight: int = 2
    window: int = 50
    _times: List[float] = dataclasses.field(default_factory=list)

    def record(self, dt: float) -> bool:
        """Record a step time; returns True if this step straggled."""
        self._times.append(dt)
        if len(self._times) > self.window:
            self._times.pop(0)
        if len(self._times) <= self.warmup_steps:
            return False
        med = statistics.median(self._times)
        return dt > self.threshold * max(med, 1e-9)

    def median(self) -> float:
        return statistics.median(self._times) if self._times else 0.0


@dataclasses.dataclass(frozen=True)
class MeshTopology:
    pod: int
    data: int
    model: int

    @property
    def chips(self) -> int:
        return self.pod * self.data * self.model


def elastic_remesh(current: MeshTopology, lost_chips: int,
                   min_data: int = 2) -> Optional[MeshTopology]:
    """Choose the next-smaller viable topology after losing chips.

    Shrinks pod first (whole-pod failures are the common case), then halves
    the data axis; the model axis is pinned (resharding TP is a weight
    relayout, done only via checkpoint restore anyway)."""
    remaining = current.chips - lost_chips
    cand = []
    for pod in range(current.pod, 0, -1):
        data = current.data
        while data >= min_data:
            t = MeshTopology(pod, data, current.model)
            if t.chips <= remaining:
                cand.append(t)
                break
            data //= 2
    if not cand:
        return None
    # tie-break: keep the data axis wide (fewer pods) — whole-pod loss is
    # the common case and intra-pod DP avoids cross-pod gradient traffic
    return max(cand, key=lambda t: (t.chips, t.data, -t.pod))


def resume_or_init(ckpt, init_fn: Callable[[], Tuple],
                   params_like=None, opt_like=None):
    """Restart protocol: newest COMMITTED checkpoint or fresh init.

    Returns (params, opt_state, start_step)."""
    step = ckpt.latest_step()
    if step is None:
        params, opt_state = init_fn()
        return params, opt_state, 0
    p_like, o_like = (params_like, opt_like)
    if p_like is None:
        p_like, o_like = init_fn()
    params, opt_state, extra = ckpt.restore(step, p_like, o_like)
    return params, opt_state, int(extra.get("next_step", step + 1))


class BoundedDispatcher:
    """Bounded in-flight step dispatch: blocks when more than `max_inflight`
    steps are unresolved (straggler back-pressure instead of queue blowup).
    A dispatched result's CUDA work is marked by an event recorded on the
    current stream of each device its leaves live on; waiting for it syncs
    on those events, and a result held on the CPU is already resolved."""

    def __init__(self, max_inflight: int = 2):
        self.max_inflight = max_inflight
        self._inflight: List = []

    def dispatch(self, result):
        self._inflight.append(record_events(result))
        if len(self._inflight) > self.max_inflight:
            wait_events(self._inflight.pop(0))
        return result

    def drain(self):
        for events in self._inflight:
            wait_events(events)
        self._inflight.clear()


def record_events(tree) -> List:
    """One CUDA event per device among the tree's CUDA leaves, recorded on
    that device's current stream."""
    devices = sorted({t.device.index for t in tree_leaves(tree)
                      if isinstance(t, torch.Tensor)
                      and t.device.type == "cuda"})
    events = []
    for index in devices:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(index))
        events.append(ev)
    return events


def wait_events(events) -> None:
    for ev in events:
        ev.synchronize()


def block_until_ready(tree) -> None:
    """Wait until the work that produces the tree's CUDA leaves is done
    (the counterpart of the reference's `jax_block`)."""
    wait_events(record_events(tree))
