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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, TensorSpec]:
    """Shape and dtype of every model input of this cell.

    train:   {tokens, labels [, frames | patch_embeds]}
    prefill: {tokens [, frames | patch_embeds]}
    decode:  {tokens (B,1)}; the caches come from `cache_shapes`.
    """
    B, S = shape.global_batch, shape.seq_len
    specs: Dict[str, TensorSpec] = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = TensorSpec((B, S - (cfg.n_patches or 0)),
                                     torch.int32)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((B, S), torch.int32)
        if cfg.n_patches:
            specs["patch_embeds"] = TensorSpec(
                (B, cfg.n_patches, cfg.d_model), torch.bfloat16)
        if cfg.is_enc_dec:
            specs["frames"] = TensorSpec((B, cfg.enc_len, cfg.d_model),
                                         torch.bfloat16)
    else:  # decode
        specs["tokens"] = TensorSpec((B, 1), torch.int32)
    return specs


# re-exports for convenience
forward_train = lm.forward_train
forward_prefill = lm.forward_prefill
forward_decode = lm.forward_decode
cache_shapes = lm.cache_shapes
init_cache = lm.init_cache
