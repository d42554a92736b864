"""smollm-135m — small llama-arch dense decoder. [hf:HuggingFaceTB/SmolLM-135M]

30L d_model=576 9H (GQA kv=3, head_dim=64) d_ff=1536 vocab=49152, tied
embeddings. Heads (9) do not divide the model axis (16): attention projections
shard on the flattened head*dim (576 = 36*16) — see DESIGN.md §7.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab=49152,
    tie_embeddings=True,
    # dp-profile arch: chunk attention scores at 4k+ (see minicpm3 note).
    long_context_threshold=2048,
    attn_chunk=1024,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    remat="none",
)
