"""olmoe-1b-7b [moe] — 64 experts top-8, every layer MoE. [arXiv:2409.02060]

16L d_model=2048 16H (MHA kv=16) expert d_ff=1024 vocab=50304, MoE 64e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    n_experts=64,
    top_k=8,
    moe_every=1,
    rope_theta=10_000.0,
)
