"""Learning-rate and lambda schedules (port of ``repro.core.schedule``).

Each schedule maps a step, a host int or a 0-d tensor, to a 0-d f32 tensor
on the step's device (the CPU for a host int), computed in f32 as the
reference does.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(value: float):
    return lambda step: torch.tensor(value, dtype=torch.float32)


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.0):
    def sched(step):
        step = _f32(step)
        warm = peak * step / max(warmup_steps, 1)
        prog = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
        return torch.where(step < warmup_steps, warm, cos)
    return sched


def lambda_ramp(lam: float, ramp_steps: int):
    """0 -> lam linearly over ramp_steps, then constant."""
    def sched(step):
        frac = torch.clamp(_f32(step) / max(ramp_steps, 1), 0.0, 1.0)
        return torch.tensor(lam, dtype=torch.float32) * frac
    return sched


def step_decay(value: float, decay: float, every: int):
    """value * decay^(step // every)."""
    def sched(step):
        k = (torch.as_tensor(step) // every).to(torch.float32)
        return torch.tensor(value, dtype=torch.float32) * torch.pow(
            torch.tensor(decay, dtype=torch.float32), k)
    return sched
