"""Checkpointing with async writes and atomic commit.

Port of `repro.checkpoint.checkpointer`, with the reference's on-disk
layout, so a checkpoint written by either package restores in the other:

  <dir>/step_<N>/
    shard_0.npz   -- every leaf, keyed "p/<path>" (params) and "o/<path>"
                     (optimizer state), the path the dict keys joined by
                     "/" in sorted order (JAX's flatten order)
    index.json    -- step, leaf count, extra (e.g. next_step)
    COMMITTED     -- atomic marker written last

bfloat16 leaves are widened to float32 on disk (npz has no bf16), which is
exact. `latest_step` finds the newest COMMITTED checkpoint; partial writes
from a crashed run are ignored and garbage-collected. `restore` moves each
leaf to its template leaf's device and dtype.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.params import tree_items, tree_map


def _flatten(tree) -> Dict[str, Any]:
    """{"a/b/c": leaf} in flatten order; keys equal the reference's."""
    return {"/".join(str(k) for k in path): leaf
            for path, leaf in tree_items(tree)}


def _np(t: torch.Tensor) -> np.ndarray:
    """A host snapshot of one leaf: a copy (the optimizer updates the
    params in place, so a view would change under an async write), bf16
    widened to float32."""
    t = t.detach().to("cpu", copy=True)
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pending: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------- save
    def save(self, step: int, params, opt_state, extra: Dict = None,
             blocking: bool = True):
        """Snapshot to the host now; write async unless blocking."""
        flat_p = {f"p/{k}": _np(v) for k, v in _flatten(params).items()}
        flat_o = {f"o/{k}": _np(v) for k, v in _flatten(opt_state).items()}

        def _write():
            target = self.dir / f"step_{step:09d}"
            tmp = self.dir / f".tmp_step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / "shard_0.npz", **flat_p, **flat_o)
            (tmp / "index.json").write_text(json.dumps({
                "step": step,
                "n_leaves": len(flat_p) + len(flat_o),
                "extra": extra or {},
            }))
            (tmp / "COMMITTED").write_text("ok")
            if target.exists():
                shutil.rmtree(target)
            tmp.rename(target)
            self._gc()

        def _write_async():
            try:
                _write()
            except BaseException as e:      # re-raised by wait()
                self._error = e

        self.wait()
        if blocking:
            _write()
        else:
            self._pending = threading.Thread(target=_write_async,
                                             daemon=True)
            self._pending.start()

    def wait(self):
        """Join the pending async write; raise its error if it failed."""
        if self._pending is not None:
            self._pending.join()
            self._pending = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = sorted(self._committed_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:09d}", ignore_errors=True)
        # remove uncommitted partials
        for p in self.dir.glob(".tmp_step_*"):
            shutil.rmtree(p, ignore_errors=True)

    # ---------------------------------------------------------- restore
    def _committed_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._committed_steps()
        return max(steps) if steps else None

    def restore(self, step: int, params_like, opt_like
                ) -> Tuple[Any, Any, Dict]:
        """Reload into the structure of `params_like` / `opt_like` (trees
        of tensors); each leaf goes to its template leaf's device and
        dtype."""
        d = self.dir / f"step_{step:09d}"
        index = json.loads((d / "index.json").read_text())
        with np.load(d / "shard_0.npz") as data:
            def _rebuild(tree, prefix):
                def leaf(path, like):
                    key = "/".join(str(k) for k in path)
                    t = torch.from_numpy(np.array(data[f"{prefix}/{key}"]))
                    return t.to(device=like.device, dtype=like.dtype)
                items = iter(tree_items(tree))
                return tree_map(lambda _: leaf(*next(items)), tree)

            params = _rebuild(params_like, "p")
            opt_state = _rebuild(opt_like, "o")
        return params, opt_state, index.get("extra", {})
