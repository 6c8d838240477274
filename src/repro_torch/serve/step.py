"""Sampling and generation: one prefill, then one decode step per token.

Port of ``repro.serve.step``. ``params`` may be a raw param tree or a
``CompressedParams``; every compressed projection then runs the spmm
kernels. Sampling draws from a ``torch.Generator``; sampled tokens are not
comparable with the JAX package's, greedy tokens are.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.models.transformer import Model
from repro_torch.serve.api import SamplingParams


def _top_k_mask(logits: torch.Tensor, top_k: int) -> torch.Tensor:
    """Keep the top-k logits, set the rest to -inf; ties at the k-th value
    all survive."""
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits >= kth, logits, float("-inf"))


def _top_p_mask(logits: torch.Tensor, top_p: float) -> torch.Tensor:
    """Nucleus filter: keep the smallest set of tokens whose cumulative
    probability reaches ``top_p`` (always at least the argmax)."""
    sort_idx = torch.argsort(-logits, dim=-1, stable=True)
    sorted_logits = torch.gather(logits, -1, sort_idx)
    probs = torch.softmax(sorted_logits, dim=-1)
    cum_before = torch.cumsum(probs, dim=-1) - probs   # exclusive cumsum
    drop_sorted = cum_before >= top_p
    drop = torch.empty_like(drop_sorted).scatter_(-1, sort_idx, drop_sorted)
    return torch.where(drop, float("-inf"), logits)


def sample_token(logits: torch.Tensor, temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None, top_k: int = 0,
                 top_p: float = 1.0) -> torch.Tensor:
    """logits (B, vocab) -> token ids (B,) int32. Greedy argmax at
    temperature 0 (or without a generator); otherwise sample from
    ``softmax(logits / temperature)`` after top-k, then top-p, filtering."""
    if temperature <= 0.0 or generator is None:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature
    if top_k and top_k > 0:
        scaled = _top_k_mask(scaled, int(top_k))
    if top_p < 1.0:
        scaled = _top_p_mask(scaled, float(top_p))
    probs = torch.softmax(scaled.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


def make_sampler(sampling: Optional[SamplingParams] = None) -> Callable:
    """``sampler(logits, generator=None) -> (B,) int32`` for one
    ``SamplingParams``."""
    sp = sampling or SamplingParams()

    def sampler(logits, generator=None):
        return sample_token(logits, sp.temperature, generator, sp.top_k,
                            sp.top_p)
    return sampler


def make_decode_step(model: Model,
                     sampling: Optional[SamplingParams] = None) -> Callable:
    sampler = make_sampler(sampling)

    def decode_step(params, inputs, cache, pos: int, generator=None):
        """inputs: (B, 1) ids. Returns (tokens (B,), logits (B, V), cache)."""
        logits, cache = model.decode_step(params, inputs, cache, pos)
        logits = logits[:, 0]
        return sampler(logits, generator), logits, cache
    return decode_step


def generate(model: Model, params, prompt: torch.Tensor, steps: int,
             sampling: Optional[SamplingParams] = None,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batched generation: one prefill of the whole prompt, then
    ``steps - 1`` decode steps. Returns (B, steps) int32 tokens."""
    sampler = make_sampler(sampling)
    decode = make_decode_step(model, sampling)
    b, s = prompt.shape
    with torch.inference_mode():
        cache = model.init_cache(b, s + steps)
        logits, cache = model.prefill(params, prompt, cache)
        out = [sampler(logits, generator)]
        for t in range(s, s + steps - 1):
            tok, _, cache = decode(params, out[-1][:, None], cache, t,
                                   generator)
            out.append(tok)
        return torch.stack(out, dim=1)
