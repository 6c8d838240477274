"""Modality frontend stand-ins (port of ``repro.models.frontends``).

``[vlm]`` (paligemma) and ``[audio]`` (musicgen) specify the transformer
backbone only; the SigLIP vision tower and the EnCodec codec are
represented by precomputed patch / frame embeddings, which the model takes
as (B, S, d) inputs in place of token ids. These helpers give the shape of
such inputs and synthetic ones for tests and examples.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def input_embedding_spec(cfg: ModelConfig, batch: int, seq: int,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """A meta tensor of the shape and dtype of frontend-provided
    embeddings (no storage)."""
    return torch.empty((batch, seq, cfg.d_model), dtype=dtype, device="meta")


def synthetic_embeddings(gen: torch.Generator, cfg: ModelConfig, batch: int,
                         seq: int, dtype=torch.float32) -> torch.Tensor:
    """Fake patch / frame embeddings, 0.02 times a standard normal drawn
    from ``gen`` on its device (the reference draws them from a
    ``jax.random`` key: the values differ, the distribution does not)."""
    return 0.02 * torch.randn((batch, seq, cfg.d_model), generator=gen,
                              device=gen.device, dtype=dtype)
