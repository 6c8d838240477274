"""smollm-360m — llama-arch small dense GQA. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
    norm="rmsnorm",
    mlp_gated=True,
    act="silu",
    tie_embeddings=True,
    rope_theta=10000.0,
    source="hf:HuggingFaceTB/SmolLM-135M; hf",
)
