"""Public model API: build/init params, forward entry points, input specs,
caches."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.device import DeviceLike
from repro_torch.models import lm
from repro_torch.models.params import TensorSpec, abstractify, materialize
from repro_torch.models.quant import quantize_spec_tree


def param_specs(cfg: ModelConfig, quantize: bool = False):
    """The model's Param-spec tree; with `quantize` the block weights are
    {"q": int8, "scale": float32} leaves (the counterpart of the
    reference's `abstract_params(cfg, quantize=True)`)."""
    specs = lm.build_param_specs(cfg)
    if quantize:
        specs = dict(specs, blocks=quantize_spec_tree(specs["blocks"]))
    return specs


def abstract_params(cfg: ModelConfig, sharding_fn=None, quantize=False):
    """TensorSpec tree of the model's params (int8 blocks with
    `quantize`), each with `sharding_fn(param)` as its sharding when
    given (`Sharder.param_sharding`); nothing is allocated."""
    return abstractify(param_specs(cfg, quantize), sharding_fn)


def init_params(generator: torch.Generator, cfg: ModelConfig, *,
                device: DeviceLike = None,
                dtype_override: Optional[torch.dtype] = None):
    """Random params from `generator` on `device` (None means the card, and
    raises without one)."""
    return materialize(lm.build_param_specs(cfg), generator=generator,
                       device=device, dtype_override=dtype_override)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                sharding_fn=None) -> Dict[str, TensorSpec]:
    """Shape and dtype of every model input of this cell, each with
    `sharding_fn(axes, shape)` as its sharding when given
    (`Sharder.act_sharding`; the reference's axes: batch first).

    train:   {tokens, labels [, frames | patch_embeds]}
    prefill: {tokens [, frames | patch_embeds]}
    decode:  {tokens (B,1)}; the caches come from `cache_shapes`.
    """
    B, S = shape.global_batch, shape.seq_len

    def mk(s, dt=torch.int32, axes=("batch", None)):
        return TensorSpec(s, dt, None if sharding_fn is None
                          else sharding_fn(axes, s))

    specs: Dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = mk((B, S - (cfg.n_patches or 0)))
        if shape.kind == "train":
            specs["labels"] = mk((B, S))
        if cfg.n_patches:
            specs["patch_embeds"] = mk((B, cfg.n_patches, cfg.d_model),
                                       torch.bfloat16, ("batch", None, None))
        if cfg.is_enc_dec:
            specs["frames"] = mk((B, cfg.enc_len, cfg.d_model),
                                 torch.bfloat16, ("batch", None, None))
    else:  # decode
        specs["tokens"] = mk((B, 1))
    return specs


# re-exports for convenience
forward_train = lm.forward_train
forward_prefill = lm.forward_prefill
forward_decode = lm.forward_decode
cache_shapes = lm.cache_shapes
init_cache = lm.init_cache
