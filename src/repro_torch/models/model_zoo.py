"""``build(arch)`` -> Model, and the input shapes of every (arch x shape)
cell (port of ``repro.models.model_zoo``)."""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import SHAPES, ModelConfig
from repro_torch.models import frontends
from repro_torch.models.transformer import Model


def build(arch, reduced: bool = False, device=None,
          sparse_backend: str = "auto") -> Model:
    """A model for an arch id or a ``ModelConfig``; ``reduced`` gives the
    small CPU-test config of the same family. ``device`` defaults to
    ``cuda``."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    if reduced:
        cfg = cfg.reduced()
    return Model(cfg, device=device, sparse_backend=sparse_backend)


def input_specs(cfg: ModelConfig, shape, data_dtype=torch.bfloat16) -> dict:
    """Meta tensors of one cell's inputs (no allocation).

    train / prefill: {"inputs": (B, S) ids or (B, S, d) frontend
                      embeddings, "labels": (B, S)}
    decode:          {"inputs": (B, 1) or (B, 1, d)}
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    b, s = shape.global_batch, shape.seq_len
    n = s if shape.kind in ("train", "prefill") else 1
    if cfg.frontend != "none":
        inputs = frontends.input_embedding_spec(cfg, b, n, data_dtype)
    else:
        inputs = torch.empty((b, n), dtype=torch.int32, device="meta")
    if shape.kind in ("train", "prefill"):
        return {"inputs": inputs,
                "labels": torch.empty((b, s), dtype=torch.int32,
                                      device="meta")}
    return {"inputs": inputs}

