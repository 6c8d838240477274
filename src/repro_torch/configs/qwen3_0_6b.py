"""qwen3-0.6b — dense GQA with per-head QK-RMSNorm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,              # Qwen3 uses head_dim 128 (> d_model/n_heads)
    d_ff=3072,
    vocab=151936,
    qk_norm=True,
    norm="rmsnorm",
    mlp_gated=True,
    act="silu",
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-8B; hf",
)
