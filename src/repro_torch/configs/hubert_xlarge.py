"""hubert-xlarge — encoder-only audio transformer (w2v2 architecture).
[arXiv:2106.07447]

48L d_model=1280 16H (kv=16, head_dim=80) d_ff=5120 vocab=504 (cluster
targets). Bidirectional attention; masked-prediction objective. The conv
waveform frontend is a STUB: input_specs provides precomputed 512-d frame
embeddings. Encoder-only: decode shapes are skipped.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab=504,
    causal=False,
    d_frontend=512,
)

SMOKE = CONFIG.scaled(
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab=64,
    d_frontend=32,
    remat="none",
)
