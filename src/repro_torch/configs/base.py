"""Model/config dataclasses for the architecture zoo.

Every assigned architecture is a ``ModelConfig`` (configs/<id>.py). This is
the port's own copy of ``repro.configs.base``; the two must stay equal.
``reduced()`` derives the CPU smoke-test config of the same family (few
layers, narrow width, tiny vocab) per the assignment.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0
    router_z_loss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | hybrid | vlm | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int                   # 0 for attention-free (rwkv)
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None
    block_pattern: tuple = ("attn",)   # repeated to n_layers
    moe: Optional[MoEConfig] = None
    qk_norm: bool = False
    attn_window: Optional[int] = None  # sliding-window size (local attention)
    rope_theta: float = 10000.0
    tie_embeddings: bool = True
    frontend: str = "none"             # none | vlm | audio (stubs)
    norm: str = "rmsnorm"              # rmsnorm | layernorm
    mlp_gated: bool = True
    act: str = "silu"                  # silu | gelu | relu2
    logit_softcap: Optional[float] = None
    lru_width: Optional[int] = None    # RG-LRU recurrence width
    conv1d_width: int = 4              # RG-LRU temporal conv
    rwkv_head_dim: int = 64
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    kv_cache_dtype: str = "compute"    # "compute" | "int8" (quantized cache)
    source: str = ""                   # provenance tag from the assignment

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def n_super_blocks(self) -> int:
        """Full pattern repeats (scanned); remainder layers are unrolled."""
        return self.n_layers // len(self.block_pattern)

    @property
    def remainder_pattern(self) -> tuple:
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    @property
    def sub_quadratic(self) -> bool:
        """Supports long_500k decode (O(1)-ish per-token state)."""
        return all(b != "attn" or self.attn_window is not None
                   for b in self.block_pattern)

    @property
    def attn_free(self) -> bool:
        return all(b in ("rwkv",) for b in self.block_pattern)

    def _layer_params(self, blk: str) -> int:
        d, ff, hd = self.d_model, self.d_ff, self.resolved_head_dim
        n = 0
        if blk == "attn":
            n += d * (self.n_heads + 2 * self.n_kv_heads) * hd
            n += self.n_heads * hd * d
            n += 2 * d                          # norms
        elif blk == "rglru":
            w = self.lru_width or d
            n += d * w * 2 + w * d              # in (x2 branch), out
            n += w * self.conv1d_width          # temporal conv
            n += 3 * w                          # a-param, input gate, rec gate
            n += 2 * d
        elif blk == "rwkv":
            n += 5 * d * d                      # r,k,v,g,o (time mix)
            n += d * 32 * 5 * 2                 # ddlerp LoRAs (approx)
            n += 2 * d
        if self.moe is not None:
            e = self.moe
            n += d * e.n_experts
            n += e.n_experts * 3 * d * e.d_ff_expert
            n += e.n_shared_experts * 3 * d * e.d_ff_expert
        elif blk == "rwkv":
            n += 2 * d * ff + d * d             # rwkv channel mix
        else:
            mult = 3 if self.mlp_gated else 2
            n += mult * d * ff
        return n

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head)."""
        d = self.d_model
        total = self.vocab * d                   # embedding
        if not self.tie_embeddings:
            total += d * self.vocab
        pat = self.block_pattern
        total += sum(self._layer_params(pat[i % len(pat)])
                     for i in range(self.n_layers))
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.n_params()
        e = self.moe
        dense_expert = e.n_experts * 3 * self.d_model * e.d_ff_expert
        active_expert = (e.top_k + e.n_shared_experts) * 3 * self.d_model * e.d_ff_expert
        return self.n_params() - (dense_expert - active_expert) * self.n_layers

    def reduced(self) -> "ModelConfig":
        """CPU smoke-test config of the same family."""
        pat = self.block_pattern
        layers = len(pat) * max(1, 2 // len(pat))   # 1-2 pattern repeats
        if self.n_layers % len(pat):
            layers += self.n_layers % len(pat)      # keep remainder-path coverage
        heads = min(self.n_heads, 4) if self.n_heads else 0
        kv = max(1, min(self.n_kv_heads, heads)) if heads else 0
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(self.moe, n_experts=4,
                                      top_k=min(self.moe.top_k, 2),
                                      d_ff_expert=64)
        return dataclasses.replace(
            self, name=self.name + "-reduced", n_layers=layers,
            d_model=64, n_heads=heads, n_kv_heads=kv, head_dim=16,
            d_ff=128, vocab=128, moe=moe,
            lru_width=64 if self.lru_width else None,
            attn_window=min(self.attn_window, 16) if self.attn_window else None,
            compute_dtype="float32")


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
