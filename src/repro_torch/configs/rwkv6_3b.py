"""rwkv6-3b (Finch) — attention-free, data-dependent decay linear RNN.
[arXiv:2404.05892; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=0,                 # attention-free
    n_kv_heads=0,
    d_ff=8960,
    vocab=65536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,          # 2560 / 64 = 40 wkv heads
    norm="layernorm",
    mlp_gated=False,
    act="relu2",               # RWKV channel-mix uses squared ReLU
    tie_embeddings=False,
    source="arXiv:2404.05892; hf",
)
