"""recurrentgemma-9b — Griffin hybrid: RG-LRU + local attention, 2:1.
[arXiv:2402.19427; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                       # 12 full (rglru, rglru, attn) patterns
    n_heads=16,                        # + 2 remainder rglru layers (the stack
    n_kv_heads=1,                      # scans the 12 patterns and unrolls the
    d_model=4096,                      # remainder; see models/transformer.py)
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    block_pattern=("rglru", "rglru", "attn"),
    attn_window=2048,                  # local attention window
    lru_width=4096,
    conv1d_width=4,
    norm="rmsnorm",
    mlp_gated=True,
    act="gelu",
    tie_embeddings=True,
    rope_theta=10000.0,
    source="arXiv:2402.19427; unverified",
)
