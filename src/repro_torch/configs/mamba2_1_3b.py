"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 d_ff=0 vocab=50280, ssm_state=128. [arXiv:2405.21060]

Mamba2 blocks have no separate FFN (d_ff=0): the block's expansion
(ssm_expand=2) is the only width multiplier, matching the reference model.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    tie_embeddings=True,
)
