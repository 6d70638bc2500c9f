"""Production mesh construction on a torch `DeviceMesh`.

Port of `repro.launch.mesh`. FUNCTIONS (not module-level constants), so
importing touches no process group. Single pod: (data=16, model=16) = 256
ranks; multi-pod: (pod=2, data=16, model=16) = 512 ranks, over the world
of the current default process group (one rank per device; a fake
process group gives the production shapes on one host without devices).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _mesh(device_type: str, shape, names):
    """A DeviceMesh of the first prod(shape) ranks of the default group."""
    from torch.distributed.device_mesh import DeviceMesh

    need = int(np.prod(shape))
    return DeviceMesh(device_type, torch.arange(need).reshape(shape),
                      mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The (16, 16) ("data", "model") mesh, or (2, 16, 16) with "pod"
    ahead, over the first ranks of the default process group.
    `device_type` defaults to "cuda" when a card is visible, else "cpu".
    Raises RuntimeError when the world holds fewer ranks than the mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if _world() < need:
        raise RuntimeError(
            f"mesh {shape} needs {need} ranks, found {_world()}: initialise "
            f"a process group of world size {need} (torch.distributed."
            "init_process_group; the 'fake' backend gives one without "
            "devices)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return _mesh(device_type, shape, axes)


def make_host_mesh(model_axis: int = 1, device: DeviceLike = None):
    """A (data, model) mesh over this host's devices: the local CUDA
    devices (`device` None or a CUDA device), or one CPU rank a process
    (`device="cpu"`), with `model_axis` of them on "model". Without a
    process group a one-rank group is started (NCCL on CUDA, gloo on the
    CPU) over a store in this process; the caller ends it with
    `torch.distributed.destroy_process_group()`."""
    import torch.distributed as dist

    dev = resolve_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            "nccl" if dev.type == "cuda" else "gloo",
            store=dist.HashStore(), rank=0, world_size=1)
    n = (min(torch.cuda.device_count(), _world()) if dev.type == "cuda"
         else _world())
    data = n // model_axis
    if data < 1:
        raise RuntimeError(f"model_axis={model_axis} exceeds the {n} "
                           "devices of this host")
    return _mesh(dev.type, (data, model_axis), ("data", "model"))
