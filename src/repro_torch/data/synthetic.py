"""Deterministic synthetic data streams (port of ``repro.data.synthetic``).

Batches are a pure function of (seed, step), so a restarted job replays
the exact token stream with no loader state to checkpoint. Generation is
numpy, as in the reference, so the port's batches equal the JAX package's;
they are returned as tensors on the caller's device.

Token streams mix Zipf-distributed unigrams with a deterministic k-gram
structure, so there is a real learning signal. Image streams give
class-conditional blobs (MNIST / CIFAR stand-ins for the CNN experiments).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenStreamConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    structure: int = 8        # k-gram period giving predictable structure


def token_batch(cfg: TokenStreamConfig, step: int, host_start: int = 0,
                host_size: Optional[int] = None, device="cpu") -> dict:
    """Batch for ``step``: rows [host_start, +host_size) of the global
    batch, as int32 tensors on ``device``."""
    host_size = host_size or cfg.global_batch
    rng = np.random.default_rng((cfg.seed, step))
    b, s, v = cfg.global_batch, cfg.seq_len, cfg.vocab
    ranks = rng.integers(1, 1000, size=(b, s + 1))
    base = (v * (ranks.astype(np.float64) ** -1.1)).astype(np.int64) % v
    k = cfg.structure
    for t in range(k, s + 1):
        mask = (np.arange(b) + t) % 3 == 0
        base[mask, t] = (base[mask, t - k] * 31 + 7) % v
    base = base[host_start:host_start + host_size]
    tokens = np.ascontiguousarray(base[:, :-1].astype(np.int32))
    labels = np.ascontiguousarray(base[:, 1:].astype(np.int32))
    return {"inputs": torch.from_numpy(tokens).to(device),
            "labels": torch.from_numpy(labels).to(device)}


def token_stream(cfg: TokenStreamConfig, start_step: int = 0,
                 device="cpu") -> Iterator[dict]:
    """The whole global batch of every step from ``start_step`` on."""
    step = start_step
    while True:
        yield token_batch(cfg, step, device=device)
        step += 1


@dataclasses.dataclass(frozen=True)
class ImageStreamConfig:
    image_shape: tuple          # (H, W, C)
    n_classes: int
    batch: int
    seed: int = 0
    noise: float = 0.35


_PROTO_CACHE: dict = {}


def _prototypes(cfg: ImageStreamConfig) -> np.ndarray:
    key = (cfg.image_shape, cfg.n_classes, cfg.seed)
    if key not in _PROTO_CACHE:
        rng = np.random.default_rng(cfg.seed + 12345)
        h, w, c = cfg.image_shape
        protos = np.zeros((cfg.n_classes, h, w, c), np.float32)
        yy, xx = np.mgrid[0:h, 0:w]
        for cls in range(cfg.n_classes):
            for _ in range(3):          # a class is a mixture of 3 blobs
                cy, cx = rng.uniform(0.2, 0.8, 2) * [h, w]
                sig = rng.uniform(0.08, 0.2) * h
                blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                              / (2 * sig ** 2))
                protos[cls] += blob[..., None] * rng.uniform(0.5, 1.0, c)
        _PROTO_CACHE[key] = protos / protos.max()
    return _PROTO_CACHE[key]


def image_batch(cfg: ImageStreamConfig, step: int, device="cpu") -> dict:
    rng = np.random.default_rng((cfg.seed, step))
    labels = rng.integers(0, cfg.n_classes, cfg.batch)
    protos = _prototypes(cfg)
    imgs = protos[labels] + cfg.noise * rng.normal(
        size=(cfg.batch,) + cfg.image_shape).astype(np.float32)
    return {"inputs": torch.as_tensor(imgs, dtype=torch.float32,
                                      device=device),
            "labels": torch.as_tensor(labels.astype(np.int32),
                                      device=device)}


MNIST_LIKE = ImageStreamConfig(image_shape=(28, 28, 1), n_classes=10, batch=128)
CIFAR_LIKE = ImageStreamConfig(image_shape=(32, 32, 3), n_classes=10, batch=128)
