"""Training losses (port of ``repro.train.losses``)."""
from __future__ import annotations

import torch


def next_token_loss(logits, labels, z_weight: float = 1e-4):
    """Causal LM loss (labels are already shifted by the data pipeline),
    plus a small logit z-loss for stability."""
    logits = logits.float()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    z = torch.square(torch.logsumexp(logits, dim=-1)).mean()
    return nll.mean() + z_weight * z


def softmax_xent(logits, labels):
    """Classification loss (the paper's CNN experiments)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -torch.gather(logp, -1, labels.long()[:, None]).mean()


def accuracy(logits, labels):
    return (torch.argmax(logits, dim=-1) == labels).float().mean()
