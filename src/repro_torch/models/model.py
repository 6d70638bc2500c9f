"""Public model API: build/init params, forward entry points, caches."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.models import lm
from repro_torch.models.params import materialize


def param_specs(cfg: ModelConfig):
    return lm.build_param_specs(cfg)


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: DeviceLike = None,
                dtype_override: Optional[torch.dtype] = None):
    """Random params from `generator` on `device` (None means the card, and
    raises without one)."""
    return materialize(lm.build_param_specs(cfg), generator=generator,
                       device=device, dtype_override=dtype_override)


# re-exports for convenience
forward_train = lm.forward_train
forward_prefill = lm.forward_prefill
forward_decode = lm.forward_decode
cache_shapes = lm.cache_shapes
init_cache = lm.init_cache
