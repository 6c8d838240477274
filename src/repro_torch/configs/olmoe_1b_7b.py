"""olmoe-1b-7b — 64-expert top-8 MoE. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,                 # per-expert FFN width
    vocab=50304,
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    qk_norm=True,              # OLMoE uses QK-norm
    norm="rmsnorm",
    mlp_gated=True,
    act="silu",
    tie_embeddings=False,
    rope_theta=10000.0,
    source="arXiv:2409.02060; hf",
)
