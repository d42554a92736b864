"""minicpm3-4b — dense decoder with MLA (multi-head latent attention).
[hf:openbmb/MiniCPM3-4B]

62L d_model=2560 40H d_ff=6400 vocab=73448; MLA: q_lora=768, kv_lora=256,
qk_nope=64, qk_rope=32, v_head=64 (per the published config).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab=73448,
    attention="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    head_dim=96,  # qk_nope + qk_rope
    # 40 heads don't divide the model axis, but every MLA latent projection
    # does (wuq 3840, wuk/wuv on kv_rank 256, ffn 6400) -> pin TP; per-head
    # attention math runs replicated over 'model' with chunked scores.
    parallelism="tp",
    long_context_threshold=2048,
    attn_chunk=512,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=256,
    q_lora_rank=32,
    kv_lora_rank=16,
    qk_nope_dim=8,
    qk_rope_dim=8,
    v_head_dim=8,
    head_dim=16,
    remat="none",
)
