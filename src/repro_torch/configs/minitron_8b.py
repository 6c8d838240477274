"""minitron-8b — pruned Nemotron dense GQA transformer. [arXiv:2407.14679; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-8b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab=256000,
    norm="layernorm",
    mlp_gated=False,           # Nemotron family: squared-ReLU non-gated MLP
    act="relu2",
    tie_embeddings=False,
    rope_theta=10000.0,
    source="arXiv:2407.14679; hf",
)
