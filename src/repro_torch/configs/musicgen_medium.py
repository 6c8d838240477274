"""musicgen-medium — decoder-only over EnCodec tokens; the EnCodec frontend is
a stub providing precomputed frame embeddings. [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,             # full MHA
    head_dim=64,
    d_ff=6144,
    vocab=2048,                # EnCodec codebook size
    frontend="audio",
    norm="layernorm",
    mlp_gated=False,           # MusicGen uses standard GELU MLP
    act="gelu",
    tie_embeddings=False,
    rope_theta=10000.0,
    source="arXiv:2306.05284; hf",
)
