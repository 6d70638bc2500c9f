"""whisper-base [audio] — encoder-decoder, conv frontend stubbed. [arXiv:2212.04356]

6L(enc)+6L(dec) d_model=512 8H (MHA) d_ff=2048 vocab=51865.
``input_specs()`` provides precomputed frame embeddings (the conv frontend
is a stub per the assignment); enc_len is the standard 1500-frame window.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    n_enc_layers=6,
    enc_len=1500,
    rope_theta=10_000.0,   # backbone uses RoPE in this repo (frontend stubbed)
    tie_embeddings=True,
)
