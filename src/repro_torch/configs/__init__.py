"""Architecture config registry (the port's own copy of ``repro.configs``).

``get_config(name)`` resolves any assigned architecture id. The paper's
four CNN ids are listed for completeness; the port has no CNN models yet.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, MoEConfig, ShapeConfig  # noqa: F401

ARCH_IDS = [
    "command-r-plus-104b",
    "minitron-8b",
    "smollm-360m",
    "qwen3-0.6b",
    "olmoe-1b-7b",
    "llama4-scout-17b-a16e",
    "recurrentgemma-9b",
    "paligemma-3b",
    "musicgen-medium",
    "rwkv6-3b",
]

PAPER_CNN_IDS = ["lenet5", "alexnet-cifar", "vgg16-cifar", "resnet32-cifar"]

_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "minitron-8b": "minitron_8b",
    "smollm-360m": "smollm_360m",
    "qwen3-0.6b": "qwen3_0_6b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "paligemma-3b": "paligemma_3b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-3b": "rwkv6_3b",
}


def get_config(name: str) -> ModelConfig:
    key = name.replace("_", "-")
    if key not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; have {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[key]}")
    return mod.CONFIG


def all_configs() -> dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCH_IDS}


def shapes_for(cfg: ModelConfig) -> list[str]:
    """Runnable shape cells for an arch (long_500k needs sub-quadratic)."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return names
