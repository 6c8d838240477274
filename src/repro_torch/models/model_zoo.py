"""``build(arch)`` -> Model (port of ``repro.models.model_zoo.build``)."""
from __future__ import annotations

from repro_torch.configs import get_config
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
