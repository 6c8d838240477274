"""paligemma-3b — SigLIP + Gemma VLM; backbone only, SigLIP patch embeddings
arrive precomputed via the stub frontend. [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=257216,
    frontend="vlm",
    norm="rmsnorm",
    mlp_gated=True,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2407.07726; hf",
)
