"""Deterministic synthetic token pipeline with sharded host loading.

Port of `repro.data.pipeline`, numpy only: the same seed and step give
the same integer tokens and labels, and the same float32 `patch_embeds`
and `frames`, as the reference. The train loop moves a batch to the
device.

Production posture: each data-parallel host materializes only its shard of
the global batch (`host_batch_slice`), steps are addressable by index
(deterministic skip-ahead on restart — no state files needed beyond the
step counter), and an async double-buffered prefetcher hides host latency.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    # markov-ish synthetic text: token t+1 = f(t) with noise, so models can
    # actually learn (loss decreases) in the examples
    noise: float = 0.3


def _mix64(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.uint64)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xFF51AFD7ED558CCD)
    x = (x ^ (x >> np.uint64(33))) * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> np.uint64(33))


def _batch_for_step(cfg: ModelConfig, shape: ShapeConfig, dcfg: DataConfig,
                    step: int, lo: int, hi: int) -> Dict[str, np.ndarray]:
    """Rows [lo, hi) of the global batch for `step` — per-row hash-addressed
    so any host slice of the same step is bit-identical to the full batch."""
    n = hi - lo
    S = shape.seq_len
    s_text = S - (cfg.n_patches or 0)
    rows = np.arange(lo, hi, dtype=np.uint64)[:, None]
    key = np.uint64((dcfg.seed * 1_000_003 + step) % (2**31))
    h1 = _mix64(rows * np.uint64(0x9E3779B97F4A7C15) + key)
    base = (h1 % np.uint64(cfg.vocab_size)).astype(np.int64)
    steps = (_mix64(h1) % np.uint64(6) + np.uint64(1)).astype(np.int64)
    pos = np.arange(S, dtype=np.int64)[None, :]
    seq = (base + steps * pos) % cfg.vocab_size
    h2 = _mix64(h1 + np.uint64(7) * pos.astype(np.uint64))
    noise_mask = (h2 % np.uint64(1024)) < np.uint64(int(dcfg.noise * 1024))
    noise_tok = (_mix64(h2) % np.uint64(cfg.vocab_size)).astype(np.int64)
    seq = np.where(noise_mask, noise_tok, seq).astype(np.int32)

    batch = {"tokens": seq[:, :s_text], "labels": seq}
    if cfg.n_patches:
        h3 = _mix64(h1 + np.uint64(13))
        rng = np.random.RandomState((int(h3[0, 0]) ^ step) % (2**31))
        batch["patch_embeds"] = rng.randn(
            n, cfg.n_patches, cfg.d_model).astype(np.float32) * 0.02
    if cfg.is_enc_dec:
        rng = np.random.RandomState((step * 7919 + lo) % (2**31))
        batch["frames"] = rng.randn(
            n, cfg.enc_len, cfg.d_model).astype(np.float32) * 0.02
    return batch


class DataPipeline:
    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 dcfg: DataConfig = DataConfig(),
                 host_index: int = 0, host_count: int = 1,
                 prefetch: int = 2):
        self.cfg, self.shape, self.dcfg = cfg, shape, dcfg
        per_host = shape.global_batch // host_count
        self.lo = host_index * per_host
        self.hi = self.lo + per_host
        self.prefetch = prefetch

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        return _batch_for_step(self.cfg, self.shape, self.dcfg, step,
                               self.lo, self.hi)

    def iterate(self, start_step: int = 0,
                stop_step: Optional[int] = None) -> Iterator[Dict]:
        """Async double-buffered iterator with deterministic skip-ahead.
        The producer thread is stopped and joined when the iterator is
        closed or exhausted (a consumer that breaks off leaves no thread
        blocked on a full queue); an error in the producer is raised in
        the consumer."""
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            s = start_step
            try:
                while stop_step is None or s < stop_step:
                    if not put((s, self.batch_at(s))):
                        return
                    s += 1
            except Exception as e:          # handed to the consumer
                put(e)
                return
            put(None)

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            th.join()
