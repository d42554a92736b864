"""Unified model configuration covering all 10 assigned architectures.

Port of ``src/repro/models/config.py``: the same dataclass, whose
``padded_vocab`` and ``param_count`` use the port's own modules.

One dataclass, one model implementation (models/model.py); families select
which sub-blocks are instantiated:

  dense   — pre-norm decoder: GQA/MLA attention + SwiGLU MLP
  moe     — dense attention + top-k routed expert MLP
  ssm     — Mamba2 SSD blocks only (attention-free)
  hybrid  — Mamba2 backbone + a weight-shared attention block every k layers
  vlm     — dense decoder + cross-attention layers every k layers (image
            patch embeddings arrive precomputed: the frontend is a stub)
  audio   — encoder-only (bidirectional) transformer over precomputed frame
            embeddings (frontend stub); masked-prediction head
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "FAMILIES"]

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    attention: str = "gqa"  # 'gqa' | 'mla' | 'none'
    causal: bool = True

    # MLA (multi-head latent attention, MiniCPM3/DeepSeek-V2 style)
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_conv_width: int = 4
    ssm_chunk: int = 256

    # hybrid (zamba2-style shared attention block)
    hybrid_attn_every: int = 0

    # vlm (llama-3.2-vision-style cross attention)
    cross_attn_every: int = 0
    n_image_tokens: int = 0

    # audio / vlm stub frontend embedding width
    d_frontend: int = 0

    # parallelism profile: 'auto' (heads-divisibility heuristic), 'tp', 'dp'
    parallelism: str = "auto"
    # attention implementation: 'xla' (plain torch matmul + softmax, the
    # reference's XLA path) or 'flash' (the hand-written CUDA online-softmax
    # kernel, kernels/csrc/flash_attention.cu; its plain version on the CPU)
    attention_impl: str = "xla"
    # ZeRO-3 parameter sharding over 'data' (default). False = params
    # replicated over 'data' (TP/EP-only storage) with ZeRO-1 moments —
    # removes per-layer weight all-gathers; right for models whose per-chip
    # TP/EP shard already fits (e.g. fine-grained MoE; §Perf cell B).
    zero3: bool = True

    # numerics / execution
    dtype: str = "bfloat16"
    # 'full' (recompute everything in bwd) is the default: at 16 GB/chip the
    # carry stack alone is the budget; 'dots' trades ~1/3 more HBM for fewer
    # recompute FLOPs and is a per-arch hillclimb lever (EXPERIMENTS.md §Perf).
    remat: str = "full"  # 'none' | 'dots' | 'full'
    # attention chunking for long sequences (memory-efficient online softmax)
    attn_chunk: int = 1024
    long_context_threshold: int = 8192

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.family in ("ssm", "hybrid") and self.ssm_state <= 0:
            raise ValueError(f"{self.family} requires ssm_state > 0")
        if self.family == "moe" and self.n_experts <= 0:
            raise ValueError("moe requires n_experts > 0")
        if self.attention == "mla" and self.kv_lora_rank <= 0:
            raise ValueError("mla requires kv_lora_rank > 0")

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to the model-axis size so the embedding/lm_head
        always shard on the vocab dim (pad logits are masked in the loss and
        sampling paths). 50280->50288, 73448->73456, 504->512."""
        from repro_torch.distributed.constants import MODEL_AXIS_SIZE

        m = MODEL_AXIS_SIZE
        return ((self.vocab + m - 1) // m) * m

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def uses_attention(self) -> bool:
        return self.family not in ("ssm",)

    @property
    def is_decoder(self) -> bool:
        return self.family != "audio"

    def param_count(self) -> int:
        """Analytical parameter count (exact for our construction)."""
        from repro_torch.models.model import count_params_analytical

        return count_params_analytical(self)

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed experts count)."""
        from repro_torch.models.model import count_params_analytical

        return count_params_analytical(self, active_only=True)

    def scaled(self, **overrides) -> "ModelConfig":
        """Derived config (used for reduced smoke-test instantiations)."""
        return dataclasses.replace(self, **overrides)
