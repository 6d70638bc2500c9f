"""The four assigned input-shape cells (shared across all LM architectures)."""
from __future__ import annotations

from repro_torch.configs.base import ShapeConfig

TRAIN_4K = ShapeConfig(name="train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig(name="prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig(name="decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig(name="long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


def shape_applicable(model, shape: ShapeConfig) -> bool:
    """long_500k needs a sub-quadratic attention path (see DESIGN.md §4)."""
    if shape.name == "long_500k":
        return model.sub_quadratic
    return True
