"""deepseek-v2-lite [moe] — latent attention (MLA), YaRN RoPE, 2 shared + 64
routed experts top-6, a leading dense layer. [arXiv:2405.04434]

27L d_model=2048 16H; MLA without a q LoRA: q/k heads of 128 + 64 (rope)
columns, v heads of 128, a 512-wide latent; YaRN factor 40 over 4,096
positions (163,840 context); layer 0 a dense SwiGLU of 10,944, layers
1-26 MoE with experts of 1,408; vocab 102,400. Published config:
https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite/blob/main/config.json
"""
from repro_torch.configs.base import PortModelConfig

CONFIG = PortModelConfig(
    name="deepseek-v2-lite",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=10944,
    vocab_size=102400,
    rope_theta=10_000.0,
    n_experts=64,
    top_k=6,
    moe_d_ff=1408,
    norm_eps=1e-6,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    yarn_factor=40.0,
    yarn_original_max_pos=4096,
    yarn_beta_fast=32.0,
    yarn_beta_slow=1.0,
    yarn_mscale=0.707,
    yarn_mscale_all_dim=0.707,
    n_shared_experts=2,
    first_dense_layers=1,
    norm_topk_prob=False,
)
