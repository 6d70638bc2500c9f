"""Architecture registry: ``--arch <id>`` → ModelConfig, plus RunConfig tuning.

The per-(arch × shape) RunConfig knobs (microbatch count, FSDP, bf16 moments)
encode how each cell is made to fit 16 GB/chip on the production mesh — see
DESIGN.md §5 and EXPERIMENTS.md §Dry-run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES_BY_NAME, shape_applicable

from repro_torch.configs.phi3_vision_4_2b import CONFIG as PHI3_VISION
from repro_torch.configs.mamba2_1_3b import CONFIG as MAMBA2
from repro_torch.configs.llama3_8b import CONFIG as LLAMA3
from repro_torch.configs.mistral_large_123b import CONFIG as MISTRAL_LARGE
from repro_torch.configs.glm4_9b import CONFIG as GLM4
from repro_torch.configs.qwen3_4b import CONFIG as QWEN3
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as JAMBA
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE
from repro_torch.configs.mixtral_8x22b import CONFIG as MIXTRAL
from repro_torch.configs.whisper_base import CONFIG as WHISPER
from repro_torch.configs.deepseek_v2_lite import CONFIG as DEEPSEEK_V2_LITE

ARCHS: Dict[str, ModelConfig] = {
    c.name: c
    for c in (
        PHI3_VISION, MAMBA2, LLAMA3, MISTRAL_LARGE, GLM4,
        QWEN3, JAMBA, OLMOE, MIXTRAL, WHISPER,
    )
}

# Architectures the port runs that the reference has not: `get_model` finds
# them, but they are no cell of `all_cells()` or the dry run, whose lists
# the tests hold equal to the reference's.
PORT_ARCHS: Dict[str, ModelConfig] = {c.name: c for c in (DEEPSEEK_V2_LITE,)}

# ZeRO-3 (FSDP) over the data axis for everything whose optimizer state
# does not comfortably fit TP-only (>= ~8B params); the giants additionally
# use bf16 Adam moments + bf16 grad accumulation to stay under 16 GB/chip.
_FSDP_ARCHS = {"llama3-8b", "glm4-9b", "mistral-large-123b",
               "jamba-1.5-large-398b", "mixtral-8x22b"}
_BF16_MOMENT_ARCHS = {"jamba-1.5-large-398b", "mixtral-8x22b",
                      "mistral-large-123b"}
# 398B-class: factored second moment (Adafactor) — Adam moments would eat
# 6.2 GB/chip on top of params+grads.
_ADAFACTOR_ARCHS = {"jamba-1.5-large-398b"}

# Grad-accumulation microbatches for train_4k (global_batch=256, data axis=16
# → 16 sequences per data shard; microbatching keeps activations + vocab logits
# within HBM).
_TRAIN_MICROBATCHES = {
    "phi-3-vision-4.2b": 8,
    "mamba2-1.3b": 8,
    "llama3-8b": 8,
    "mistral-large-123b": 16,
    "glm4-9b": 16,
    "qwen3-4b": 8,
    "jamba-1.5-large-398b": 16,
    "olmoe-1b-7b": 8,
    "mixtral-8x22b": 16,
    "whisper-base": 4,
}


def get_model(arch: str) -> ModelConfig:
    known = {**ARCHS, **PORT_ARCHS}
    if arch not in known:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(known)}")
    return known[arch]


def get_run_config(arch: str, shape_name: str) -> RunConfig:
    model = get_model(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if not shape_applicable(model, shape):
        raise ValueError(
            f"cell ({arch} x {shape_name}) is skipped: pure full-attention arch "
            "has no sub-quadratic path for 512k decode (DESIGN.md §4)"
        )
    return RunConfig(
        model=model,
        shape=shape,
        microbatches=_TRAIN_MICROBATCHES[arch] if shape.kind == "train" else 1,
        remat=shape.kind == "train",
        fsdp=arch in _FSDP_ARCHS,
        bf16_moments=arch in _BF16_MOMENT_ARCHS,
        optimizer="adafactor" if arch in _ADAFACTOR_ARCHS else "adamw",
        seq_shard_decode=(shape.name == "long_500k"),
    )


def all_cells():
    """Yield every (arch, shape) cell with its applicability flag (40 total)."""
    for arch, model in ARCHS.items():
        for shape in SHAPES_BY_NAME.values():
            yield arch, shape.name, shape_applicable(model, shape)


def reduced_model(model: ModelConfig) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests (shapes scale down,
    structure — GQA ratios, MoE top-k, hybrid interleave — is preserved)."""
    kw = dict(
        name=model.name + "-smoke",
        n_layers=min(model.n_layers, 4 if not model.is_hybrid else 8),
        d_model=128,
        d_ff=256 if model.d_ff else 0,
        vocab_size=512,
        d_head=32 if model.n_heads else None,
    )
    if model.n_heads:
        ratio = max(1, model.n_heads // max(model.n_kv_heads, 1))
        kw["n_heads"] = 4
        kw["n_kv_heads"] = max(1, 4 // ratio)
    if model.is_moe:
        kw["n_experts"] = min(model.n_experts, 8)
        kw["top_k"] = min(model.top_k, 2)
        kw["moe_d_ff"] = 64 if model.moe_d_ff else None
    if model.ssm_state:
        kw["ssm_state"] = 16
        kw["ssm_head_dim"] = 16
        kw["ssm_chunk"] = 16
    if model.is_enc_dec:
        kw["n_enc_layers"] = 2
        kw["enc_len"] = 24
    if model.n_patches:
        kw["n_patches"] = 8
    kw["kv_page_size"] = 16
    return dataclasses.replace(model, **kw)
