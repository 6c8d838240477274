"""command-r-plus-104b — dense GQA transformer, no-bias.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=33792,
    vocab=256000,
    norm="layernorm",          # Cohere uses LayerNorm (no bias)
    mlp_gated=True,
    act="silu",
    tie_embeddings=True,       # Cohere ties input/output embeddings
    rope_theta=75_000_000.0,
    kv_cache_dtype="int8",     # 550 GB bf16 cache at decode_32k -> int8
                               # halves it (fits 16 GB/dev on one pod)
    source="hf:CohereForAI/c4ai-command-r-v01; unverified",
)
