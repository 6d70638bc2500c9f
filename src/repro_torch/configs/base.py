"""Base model/run configuration dataclasses.

Every assigned architecture is expressed as a ``ModelConfig``. Configs are
plain frozen dataclasses so they can be hashed into jit static args and
serialized into checkpoints / dry-run reports.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters (exact values from the assignment table)."""

    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention details ---
    d_head: Optional[int] = None          # explicit head dim (qwen3); else d_model//n_heads
    qk_norm: bool = False                 # qwen3-style per-head RMSNorm on q,k
    sliding_window: Optional[int] = None  # mixtral SWA
    rope_theta: float = 500_000.0
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: Optional[int] = None        # expert FFN width if != d_ff
    moe_every: int = 1                    # MoE FFN every k-th layer (jamba: 2)
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0                    # d_state
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256                  # SSD chunk length
    attn_every: int = 0                   # hybrid: attention layer every k-th (jamba: 8)
    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0
    enc_len: int = 0                      # fixed encoder frame count (frontend stub)
    # --- multimodal stub ---
    n_patches: int = 0                    # vlm: prepended precomputed patch embeddings
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    # --- serving / paged-KV (the MASK-managed memory) ---
    kv_page_size: int = 128               # tokens per KV page
    def __getattr__(self, name):
        """`PortModelConfig`'s settings, read from a reference model, at
        their defaults, which leave it as it is (they are no fields here,
        so that `dataclasses.asdict` of one stays the reference's)."""
        try:
            return PORT_DEFAULTS[name]
        except KeyError:
            raise AttributeError(name) from None

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding-table rows padded to a multiple of 128 so the vocab dim
        shards evenly (Megatron-style). ``vocab_size`` stays the logical
        vocab; padded logits are masked in the loss."""
        return ((self.vocab_size + 127) // 128) * 128

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_enc_dec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_hybrid(self) -> bool:
        return self.attn_every > 0

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff if self.moe_d_ff is not None else self.d_ff

    @property
    def is_mla(self) -> bool:
        return self.kv_lora_rank > 0

    @property
    def qk_head_dim(self) -> int:
        """Width of a q or k head: the MLA's nope + rope parts, else
        head_dim."""
        return (self.qk_nope_head_dim + self.qk_rope_head_dim
                if self.is_mla else self.head_dim)

    @property
    def latent_dim(self) -> int:
        """Columns of the MLA's cache a token a layer: the normed latent
        and the rotated k_pe."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def sub_quadratic(self) -> bool:
        """Whether the arch supports long_500k (sub-quadratic attention path)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window is not None

    # ------------------------------------------------------------------
    # Parameter counting (used for MODEL_FLOPS = 6*N*D in the roofline)
    # ------------------------------------------------------------------
    def _attn_params(self) -> int:
        if self.is_mla:
            H, r = self.n_heads, self.kv_lora_rank
            q = self.d_model * H * self.qk_head_dim
            kv_a = self.d_model * self.latent_dim + r      # + latent norm
            kv_b = r * H * (self.qk_nope_head_dim + self.v_head_dim)
            return q + kv_a + kv_b + H * self.v_head_dim * self.d_model
        dh = self.head_dim
        q = self.d_model * self.n_heads * dh
        kv = 2 * self.d_model * self.n_kv_heads * dh
        o = self.n_heads * dh * self.d_model
        return q + kv + o

    def _dense_ffn_params(self, d_ff: int) -> int:
        return 3 * self.d_model * d_ff  # SwiGLU: gate, up, down

    def _ssm_params(self) -> int:
        d_inner = self.ssm_expand * self.d_model
        nh = d_inner // self.ssm_head_dim
        in_proj = self.d_model * (2 * d_inner + 2 * self.ssm_state + nh)
        out_proj = d_inner * self.d_model
        conv = self.ssm_conv_width * (d_inner + 2 * self.ssm_state)
        extra = 2 * nh + d_inner  # A_log, dt_bias, D
        return in_proj + out_proj + conv + extra

    def layer_kinds(self) -> Tuple[str, ...]:
        """Sequence of per-layer kinds: 'attn' | 'mla' | 'ssm' for the
        mixer."""
        if self.is_mla:
            return tuple("mla" for _ in range(self.n_layers))
        if self.family == "ssm":
            return tuple("ssm" for _ in range(self.n_layers))
        if self.is_hybrid:
            # jamba: attention every `attn_every`-th layer (1:7 mamba:attn)
            return tuple(
                "attn" if (i % self.attn_every) == (self.attn_every // 2) else "ssm"
                for i in range(self.n_layers)
            )
        return tuple("attn" for _ in range(self.n_layers))

    def ffn_kinds(self) -> Tuple[str, ...]:
        if not self.is_moe:
            return tuple("dense" for _ in range(self.n_layers))
        return tuple(
            "moe" if i >= self.first_dense_layers
            and (i % self.moe_every) == (self.moe_every - 1) else "dense"
            for i in range(self.n_layers)
        )

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active per-token) parameter count."""
        total = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            total += self.vocab_size * self.d_model  # lm head
        kinds, ffns = self.layer_kinds(), self.ffn_kinds()
        for kind, ffn in zip(kinds, ffns):
            total += 2 * self.d_model  # norms
            total += (self._attn_params() if kind in ("attn", "mla")
                      else self._ssm_params())
            if ffn == "moe":
                e = self.top_k if active_only else self.n_experts
                total += (e + self.n_shared_experts) * \
                    self._dense_ffn_params(self.expert_d_ff)
                total += self.d_model * self.n_experts  # router
            else:
                total += self._dense_ffn_params(self.d_ff)
        # encoder stack (whisper)
        for _ in range(self.n_enc_layers):
            total += 2 * self.d_model
            total += self._attn_params() + self._dense_ffn_params(self.d_ff)
        if self.is_enc_dec:  # cross attention in each decoder layer
            total += self.n_layers * (self._attn_params() + self.d_model)
        total += self.d_model  # final norm
        return total


@dataclasses.dataclass(frozen=True)
class PortModelConfig(ModelConfig):
    """An architecture the port runs past the reference's (DeepSeek-V2):
    ModelConfig's fields and these."""

    # --- latent attention (MLA): k and v from a latent of kv_lora_rank a
    # token; q/k heads of qk_nope + qk_rope columns, v heads of
    # v_head_dim; kv_lora_rank 0 means no MLA ---
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- YaRN RoPE (rope_scaling of type yarn); factor 1: plain RoPE ---
    yarn_factor: float = 1.0
    yarn_original_max_pos: int = 0
    yarn_beta_fast: float = 32.0
    yarn_beta_slow: float = 1.0
    yarn_mscale: float = 1.0
    yarn_mscale_all_dim: float = 0.0
    # --- MoE ---
    n_shared_experts: int = 0             # one SwiGLU of n x expert width
    first_dense_layers: int = 0           # leading dense FFN layers
    norm_topk_prob: bool = True           # renormalise the top-k gates


PORT_DEFAULTS = {f.name: f.default
                 for f in dataclasses.fields(PortModelConfig)
                 if f.name not in ModelConfig.__dataclass_fields__}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Execution configuration for a (model, shape, mesh) cell."""

    model: ModelConfig
    shape: ShapeConfig
    microbatches: int = 1            # grad-accumulation steps for training
    remat: bool = True
    fsdp: bool = False               # ZeRO-3 param/optim sharding over data axis
    bf16_moments: bool = False       # bf16 Adam moments (398B-class models)
    optimizer: str = "adamw"         # adamw | adafactor (giant MoE)
    attention_impl: str = "xla_blocked"  # xla_blocked | pallas_flash | naive
    seq_shard_decode: bool = False   # sequence-parallel KV for long decode
    quantize_weights: bool = False   # §Perf C2: int8 weight-only serving
    decode_relax_batch: bool = False  # §Perf C1: unpin batch->data on decode
    #   activations (cache stays sharded); lets SPMD move tiny activations
    #   instead of all-gathering FSDP weights every token step
    attn_block_q: int = 512
    attn_block_k: int = 1024
