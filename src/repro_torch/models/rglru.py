"""Griffin / RecurrentGemma recurrent block: temporal conv + RG-LRU.

Port of ``repro.models.rglru``. RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(w_a * u_t + b_a)         (recurrence gate, elementwise)
    i_t = sigmoid(w_x * u_t + b_x)         (input gate, elementwise)
    log a_t = -c * softplus(A) * r_t       (A learned per channel, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

Block: y = W_out( GeLU(W_gate x) * RGLRU(conv1d(W_in x)) ). The three
projections take an optional map of BlockCSR / PaletteBCSR weights and then
run ``sparse_matmul``; the depthwise conv and the gates stay dense.

The reference's ``jax.lax.associative_scan`` becomes a log-depth doubling
(Hillis-Steele) scan over the sequence axis: ceil(log2 S) steps of a few
elementwise products each, where a Python loop over S would launch
thousands of small kernels at full width. It combines the same pairs
``(a2 * a1, a2 * b1 + b2)`` as the associative scan in another order, so
the two agree to f32 rounding (the CPU tests hold them to 1e-5).

Training differentiates the scan by autograd: each doubling step saves its
(a, b) pair, so a layer keeps ceil(log2 S) pairs of (B, S, w) f32 tensors
for the backward, about 100 MB a layer at recurrentgemma-9b's width (w
4096) and a batch of 8 x 64 (6 pairs of 8.4 MB).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_proj, truncated_normal_init

Tensor = torch.Tensor
_C = 8.0


def init_rglru(cfg: ModelConfig, generator=None, device=None) -> dict:
    d = cfg.d_model
    w = cfg.lru_width or d
    cw = cfg.conv1d_width

    def init(shape):
        return truncated_normal_init(shape, 1.0, generator, device)

    zeros = torch.zeros(w, device=device)
    return {
        "lru_in": init((d, w)), "lru_gate": init((d, w)),
        "lru_out": init((w, d)), "conv1d": init((cw, w)),
        # a = exp(-c * softplus(A)) spans about (0.9, 0.999)
        "rglru_a_param": torch.linspace(-2.0, 1.0, w, device=device),
        "gate_w_a": zeros.clone(), "gate_b_a": zeros.clone(),
        "gate_w_x": zeros.clone(), "gate_b_x": zeros.clone(),
    }


def _causal_conv(u: Tensor, kern: Tensor, state: Optional[Tensor]):
    """u: (B, S, w); kern: (cw, w) depthwise causal conv. state: (B, cw-1,
    w) trailing context of the previous step, or None (left zero pad).
    Returns (out, new_state)."""
    cw = kern.shape[0]
    if state is None:
        pad = u.new_zeros((u.shape[0], cw - 1, u.shape[2]))
    else:
        pad = state.to(u.dtype)
    ux = torch.cat([pad, u], dim=1)                 # (B, S+cw-1, w)
    s = u.shape[1]
    out = sum(ux[:, i:i + s] * kern[i].to(u.dtype) for i in range(cw))
    new_state = ux[:, -(cw - 1):] if cw > 1 else pad
    return out, new_state


def _rglru_coeffs(p: dict, u: Tensor):
    u32 = u.float()
    r = torch.sigmoid(p["gate_w_a"] * u32 + p["gate_b_a"])
    i = torch.sigmoid(p["gate_w_x"] * u32 + p["gate_b_x"])
    log_a = -_C * F.softplus(p["rglru_a_param"]) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * u32)
    return a, b


def _lru_scan(a: Tensor, b: Tensor) -> Tensor:
    """Inclusive scan of h_t = a_t * h_{t-1} + b_t over axis 1 (f32), by
    doubling: after the step of offset k, (a_t, b_t) composes the up to
    2k steps ending at t."""
    s = a.shape[1]
    k = 1
    while k < s:
        a_prev, b_prev = a[:, :-k], b[:, :-k]
        b = torch.cat([b[:, :k], a[:, k:] * b_prev + b[:, k:]], dim=1)
        a = torch.cat([a[:, :k], a[:, k:] * a_prev], dim=1)
        k *= 2
    return b


def rglru_scan(p: dict, u: Tensor, h0: Optional[Tensor] = None):
    """u: (B, S, w) -> (h (B, S, w) in u's dtype, h_last (B, w) f32)."""
    a, b = _rglru_coeffs(p, u)
    if h0 is not None:
        # fold the carried state into the first step's offset
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    h = _lru_scan(a, b)
    return h.to(u.dtype), h[:, -1]


def rglru_step(p: dict, u: Tensor, h: Tensor):
    """One decode step. u: (B, 1, w); h: (B, w)."""
    a, b = _rglru_coeffs(p, u)
    h2 = a[:, 0] * h.float() + b[:, 0]
    return h2[:, None].to(u.dtype), h2


def _gelu(x: Tensor) -> Tensor:
    return F.gelu(x, approximate="tanh")        # jax.nn.gelu's default


def apply_rglru_block(p: dict, x: Tensor, cfg: ModelConfig,
                      state: Optional[dict] = None,
                      sparse: Optional[dict] = None, backend: str = "auto"):
    """Griffin recurrent block. ``state`` None: the full-sequence
    train / prefill scan from a zero state; else one decode step.

    Returns (y, new_state) with state = {"h": (B, w) f32, "conv": (B,
    cw-1, w)}."""
    gate = _gelu(apply_proj(p, x, "lru_gate", sparse, backend))
    u = apply_proj(p, x, "lru_in", sparse, backend)
    u, new_conv = _causal_conv(u, p["conv1d"],
                               state["conv"] if state is not None else None)
    if state is None:
        h, h_last = rglru_scan(p, u)
    else:
        h, h_last = rglru_step(p, u, state["h"])
    y = apply_proj(p, gate * h, "lru_out", sparse, backend)
    return y, {"h": h_last, "conv": new_conv}


def apply_rglru_block_paged(p: dict, x: Tensor, cfg: ModelConfig,
                            state: dict, n_tokens: Tensor,
                            sparse: Optional[dict] = None,
                            backend: str = "auto"):
    """Slot-pooled Griffin block: the engine's mixed step (any mix of
    prefill chunks and one-token decodes).

    x: (B, C, d), slot i carrying ``n_tokens[i]`` valid tokens (0 =
    inactive); state: the slot-indexed pool {"h": (B, w) f32, "conv": (B,
    cw-1, w)}. Invalid tail positions get identity scan coefficients (a =
    1, b = 0, exact in IEEE), so the scan's last element is the state after
    exactly ``n_tokens`` updates and inactive slots keep theirs bit for bit;
    the conv context is re-gathered at each slot's own valid length.
    Returns (y, new_state); the caller writes the state back."""
    cw = cfg.conv1d_width
    c = x.shape[1]
    valid = (torch.arange(c, dtype=torch.int32, device=x.device)[None, :]
             < n_tokens[:, None])[..., None]

    gate = _gelu(apply_proj(p, x, "lru_gate", sparse, backend))
    u = apply_proj(p, x, "lru_in", sparse, backend)

    # valid positions only read positions <= themselves (a valid prefix),
    # so the input needs no masking
    kern = p["conv1d"]
    pad = state["conv"].to(u.dtype)
    ux = torch.cat([pad, u], dim=1)                 # (B, C+cw-1, w)
    u = sum(ux[:, i:i + c] * kern[i].to(u.dtype) for i in range(cw))
    if cw > 1:
        idx = (n_tokens.long()[:, None]
               + torch.arange(cw - 1, device=x.device)[None, :])
        new_conv = torch.gather(ux, 1, idx[:, :, None].expand(-1, -1, ux.shape[2]))
    else:
        new_conv = pad
    new_conv = new_conv.to(state["conv"].dtype)

    a, b = _rglru_coeffs(p, u)
    a = torch.where(valid, a, 1.0)
    b = torch.where(valid, b, 0.0)
    b = torch.cat([b[:, :1] + a[:, :1] * state["h"][:, None], b[:, 1:]], dim=1)
    h = _lru_scan(a, b)
    h_last = h[:, -1]
    y = apply_proj(p, gate * h.to(u.dtype), "lru_out", sparse, backend)
    return y, {"h": h_last, "conv": new_conv}


def init_rglru_state(cfg: ModelConfig, batch: int, dtype, device=None) -> dict:
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((batch, w), device=device),
            "conv": torch.zeros((batch, cfg.conv1d_width - 1, w), dtype=dtype,
                                device=device)}
