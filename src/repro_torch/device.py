"""Device resolution for the port's entry points.

`None` means the card ("cuda"). Asking for CUDA where no card is visible
raises: nothing quietly carries on on the CPU. The CPU is used only when
the caller names it, as the parity tests do.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch.device an entry point runs on; raises if it is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is visible; "
            "pass device='cpu' to run the port on the CPU explicitly")
    return dev
