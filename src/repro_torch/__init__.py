"""PyTorch/CUDA port of ``repro``: compressed (BlockCSR / PaletteBCSR)
serving on an NVIDIA H100.

The package mirrors ``repro``'s layout module for module and imports
neither ``jax`` nor ``repro``. Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; they never fall back to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Asking for CUDA without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
