"""llama-3.2-vision-90b — decoder with gated cross-attention image layers
every 5th layer. [hf:meta-llama/Llama-3.2-90B-Vision]

100L d_model=8192 64H (GQA kv=8, head_dim=128) d_ff=28672 vocab=128256.
The vision tower is a STUB: input_specs provides precomputed patch embeddings
[B, 1601, 1280] (40x40 patches + CLS at the published 560px resolution).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    cross_attn_every=5,
    n_image_tokens=1601,
    d_frontend=1280,
    rope_theta=500000.0,
    # Chunk attention scores at 4k+ (grouped remat keeps only group carries;
    # chunking bounds the recomputed score blocks in the group backward).
    long_context_threshold=2048,
    attn_chunk=1024,
)

SMOKE = CONFIG.scaled(
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    cross_attn_every=2,
    n_image_tokens=8,
    d_frontend=32,
    remat="none",
)
