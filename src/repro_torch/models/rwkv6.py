"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free, data-dependent decay.

Port of ``repro.models.rwkv6``. Time mixing, per head (dk = dv = head_dim):
    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    o_t = r_t ( S_{t-1} + diag(u) k_t^T v_t )
with token-shift ddlerp (a LoRA on the decay input) giving the r, k, v, g
and decay inputs, and w_t = exp(-exp(tdecay_t)) per channel.

Train / prefill use the chunked parallel form (``chunked_wkv``: chunks of
64, the intra-chunk part a masked (L, L) product, the inter-chunk part a
loop over chunks carrying the (dk, dv) state), all in f32 with the
cumulative log-decay clamped at 25. Decode is the O(1) recurrence
(``wkv_step``), and the engine's mixed step a loop over the tick's
positions with a masked state advance (``wkv_scan``). Channel mixing is
the squared-ReLU FFN with token shift. The r/k/v/g/o and channel-mix
projections take an optional map of BlockCSR / PaletteBCSR weights and
then run ``sparse_matmul``.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_proj, truncated_normal_init

Tensor = torch.Tensor
_LORA_R = 32
_CHUNK = 64
_CLAMP = 25.0      # max |cumulative log-decay| inside a chunk (exp(25)~7e10)


def _lora(d: int, out: int, generator, device, r: int = _LORA_R) -> dict:
    return {"lora_a": truncated_normal_init((d, r), 1.0, generator, device),
            "lora_b": torch.zeros((r, out), device=device)}


def _apply_lora(p: dict, x: Tensor) -> Tensor:
    """tanh(x A) B in f32. Training casts the LoRA's f32 masters to the
    compute dtype; the reference's einsum promotes them back against the
    f32 activation, as the ``float()`` calls do here."""
    h = torch.tanh(x.float() @ p["lora_a"].float())
    return h @ p["lora_b"].float()


def init_time_mix(cfg: ModelConfig, generator=None, device=None) -> dict:
    d = cfg.d_model

    def init(shape):
        return truncated_normal_init(shape, 1.0, generator, device)

    return {
        "rwkv_r": init((d, d)), "rwkv_k": init((d, d)),
        "rwkv_v": init((d, d)), "rwkv_g": init((d, d)),
        "rwkv_o": init((d, d)),
        "time_decay_base": torch.linspace(-6.0, -1.0, d, device=device),
        "time_first": torch.linspace(0.1, 1.0, d, device=device),
        "mu": {name: torch.full((d,), 0.5, device=device)
               for name in ("r", "k", "v", "g", "w")},
        "lora_w": _lora(d, d, generator, device),
        "ln_x_scale": torch.ones(d, device=device),
    }


def init_channel_mix(cfg: ModelConfig, generator=None, device=None) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "cm_k": truncated_normal_init((d, ff), 2.0, generator, device),
        "cm_v": truncated_normal_init((ff, d), 2.0, generator, device),
        "cm_r": truncated_normal_init((d, d), 1.0, generator, device),
        "mu_k": torch.full((d,), 0.5, device=device),
        "mu_r": torch.full((d,), 0.5, device=device),
    }


def _token_shift(x: Tensor, last: Optional[Tensor]) -> Tensor:
    """x_{t-1}, with the previous step's trailing token (decode) or zeros."""
    pad = (torch.zeros_like(x[:, :1]) if last is None
           else last[:, None].to(x.dtype))
    return torch.cat([pad, x[:, :-1]], dim=1)


def _heads(x: Tensor, hd: int) -> Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, d // hd, hd)


def chunked_wkv(r, k, v, logw, u, state, chunk: int = _CHUNK):
    """Chunked linear attention with per-channel data-dependent decay.

    r, k, v, logw: (B, S, H, hd) (logw <= 0); u: (H, hd); state: (B, H,
    hd, hd) or None. S must be a multiple of the chunk or shorter than it,
    as in the reference. Returns (o (B, S, H, hd) f32, state')."""
    b, s, h, hd = r.shape
    if not (s % chunk == 0 or s < chunk):
        raise ValueError(f"sequence length {s} must be a multiple of the "
                         f"chunk {chunk} or shorter than it")
    chunk = min(chunk, s)
    n = s // chunk

    def split(x):                                   # (n, B, H, L, hd)
        return x.float().reshape(b, n, chunk, h, hd).permute(1, 0, 3, 2, 4)

    rs, ks_, vs, lws = split(r), split(k), split(v), split(logw)
    if state is None:
        state = torch.zeros((b, h, hd, hd), device=r.device)
    tri_strict = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                       device=r.device), -1)
    uu = u[None, :, None, :]
    outs = []
    for i in range(n):
        rc, kc, vc, lw = rs[i], ks_[i], vs[i], lws[i]     # (B, H, L, hd)
        cum = torch.cumsum(lw, dim=2)               # inclusive
        cum_prev = cum - lw                         # exclusive (up to t-1)
        total = cum[:, :, -1:, :]                   # (B, H, 1, hd)
        # inter-chunk: o_t += (r_t * exp(cum_prev)) @ S
        r_dec = rc * torch.exp(cum_prev)
        o = torch.einsum("bhld,bhdv->bhlv", r_dec, state)
        # intra-chunk: A[t, i] = sum_d r[t,d] k[i,d] exp(cum_prev[t]-cum[i]), i < t
        k_dec = kc * torch.exp(torch.clamp(-cum, max=_CLAMP))
        att = torch.einsum("bhld,bhmd->bhlm", r_dec, k_dec)
        att = torch.where(tri_strict, att, 0.0)
        o = o + torch.einsum("bhlm,bhmv->bhlv", att, vc)
        # current-token bonus: o_t += (r_t * u * k_t) . v_t
        bonus = torch.sum(rc * uu * kc, dim=-1, keepdim=True)
        o = o + bonus * vc
        # state: S' = diag(exp(total)) S + sum_i exp(total - cum_i) k_i v_i
        k_carry = kc * torch.exp(torch.clamp(total - cum, max=_CLAMP))
        state = (torch.exp(total)[..., 0, :, None] * state
                 + torch.einsum("bhld,bhlv->bhdv", k_carry, vc))
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(b, s, h, hd)
    return o, state


def wkv_step(r, k, v, logw, u, state):
    """O(1) decode recurrence. r, k, v, logw: (B, 1, H, hd)."""
    rc, kc, vc = (x[:, 0].float() for x in (r, k, v))
    w = torch.exp(logw[:, 0].float())               # (B, H, hd)
    kv = torch.einsum("bhd,bhv->bhdv", kc, vc)
    # u ("bonus") weights the k index (dk), not dv
    o = torch.einsum("bhd,bhdv->bhv", rc, state + u[None, :, :, None] * kv)
    state2 = w[..., None] * state + kv
    return o[:, None], state2


def wkv_scan(r, k, v, logw, u, state, valid):
    """The O(1) recurrence over a tick's C positions, with the state
    advanced only at valid positions: the engine's mixed step.

    r, k, v, logw: (B, C, H, hd); u: (H, hd); state: (B, H, hd, hd) f32;
    valid: (B, C) bool. A slot whose tick carries c < C tokens ends with
    exactly c updates applied; inactive slots keep their state bit for
    bit. Returns (o (B, C, H, hd) f32, state')."""
    rs, ks_, vs, lws = (x.float() for x in (r, k, v, logw))
    uu = u[None, :, :, None]
    outs = []
    for t in range(r.shape[1]):
        rc, kc, vc = rs[:, t], ks_[:, t], vs[:, t]
        kv = torch.einsum("bhd,bhv->bhdv", kc, vc)
        outs.append(torch.einsum("bhd,bhdv->bhv", rc, state + uu * kv))
        nxt = torch.exp(lws[:, t])[..., None] * state + kv
        state = torch.where(valid[:, t, None, None, None], nxt, state)
    return torch.stack(outs, dim=1), state


def _time_mix_inputs(p: dict, x: Tensor, cfg: ModelConfig, shift,
                     sparse: Optional[dict], backend: str):
    """Token-shift ddlerp and the r/k/v/g/decay projections shared by every
    time-mix entry point. Returns (rh, kh, vh, lwh, u, g), r/k/v/logw split
    into (B, S, H, hd) heads."""
    dt = x.dtype
    hd = cfg.rwkv_head_dim
    prev = _token_shift(x, shift)
    xx = (prev - x).float()
    x32 = x.float()

    def mix(name):
        return (x32 + xx * p["mu"][name]).to(dt)

    xr, xk, xv, xg, xw = (mix(nm) for nm in ("r", "k", "v", "g", "w"))
    # r, k, v and the gate's pre-activation stay in f32: XLA, as the
    # reference is compiled, drops the bf16 round trip between these
    # products and the f32 math that reads them, and the WKV's
    # exponentials amplify that rounding into the gradients
    r = apply_proj(p, xr, "rwkv_r", sparse, backend, f32=True)
    k = apply_proj(p, xk, "rwkv_k", sparse, backend, f32=True)
    v = apply_proj(p, xv, "rwkv_v", sparse, backend, f32=True)
    g = F.silu(apply_proj(p, xg, "rwkv_g", sparse, backend, f32=True)).to(dt)

    tdecay = p["time_decay_base"] + _apply_lora(p["lora_w"], xw)
    logw = -torch.exp(tdecay.float())               # (B, S, d), <= 0
    u = p["time_first"].reshape(-1, hd)             # (H, hd)
    return _heads(r, hd), _heads(k, hd), _heads(v, hd), _heads(logw, hd), u, g


def _time_mix_output(p: dict, o: Tensor, g: Tensor, x: Tensor, hd: int,
                     sparse: Optional[dict], backend: str) -> Tensor:
    """Per-head group norm (ln_x), the silu gate, the output projection."""
    dt = x.dtype
    b, s = x.shape[0], x.shape[1]
    oh = o.reshape(b, s, -1, hd)
    mu = oh.mean(-1, keepdim=True)
    var = oh.var(-1, unbiased=False, keepdim=True)
    o = ((oh - mu) * torch.rsqrt(var + 1e-5)).reshape(b, s, -1)
    o = (o * p["ln_x_scale"]).to(dt) * g
    return apply_proj(p, o, "rwkv_o", sparse, backend)


def _shift_update(x: Tensor, n_tokens: Tensor, old: Tensor) -> Tensor:
    """The token-shift carry of the slot-pooled paths: each slot's last
    VALID input; slots with no tokens this tick keep theirs."""
    idx = (n_tokens.long() - 1).clamp(0, x.shape[1] - 1)
    last = torch.gather(x, 1, idx[:, None, None].expand(-1, 1, x.shape[2]))[:, 0]
    return torch.where((n_tokens > 0)[:, None], last.float(), old)


def apply_time_mix(p: dict, x: Tensor, cfg: ModelConfig,
                   state: Optional[dict] = None,
                   sparse: Optional[dict] = None, backend: str = "auto"):
    """RWKV-6 time mixing. state = {"S": (B, H, hd, hd), "shift": (B, d)}
    or None (the full-sequence chunked form from a zero state)."""
    hd = cfg.rwkv_head_dim
    rh, kh, vh, lwh, u, g = _time_mix_inputs(
        p, x, cfg, state["shift"] if state else None, sparse, backend)
    if state is None:
        o, s_new = chunked_wkv(rh, kh, vh, lwh, u, None)
    else:
        o, s_new = wkv_step(rh, kh, vh, lwh, u, state["S"])
    o = o.reshape(x.shape[0], x.shape[1], -1)
    y = _time_mix_output(p, o, g, x, hd, sparse, backend)
    return y, {"S": s_new, "shift": x[:, -1].float()}


def apply_time_mix_paged(p: dict, x: Tensor, cfg: ModelConfig, state: dict,
                         n_tokens: Tensor, sparse: Optional[dict] = None,
                         backend: str = "auto"):
    """Slot-pooled time mixing: the engine's mixed step. x: (B, C, d), slot
    i carrying ``n_tokens[i]`` valid tokens; state: the slot-indexed pool
    {"S", "shift"}. The shift carry crosses chunk boundaries through
    ``state["shift"]`` and the WKV state advances by ``wkv_scan``, so
    chunked prefill equals the sequential recurrence."""
    hd = cfg.rwkv_head_dim
    valid = (torch.arange(x.shape[1], dtype=torch.int32, device=x.device)[None, :]
             < n_tokens[:, None])
    rh, kh, vh, lwh, u, g = _time_mix_inputs(p, x, cfg, state["shift"],
                                             sparse, backend)
    o, s_new = wkv_scan(rh, kh, vh, lwh, u, state["S"], valid)
    o = o.reshape(x.shape[0], x.shape[1], -1)
    y = _time_mix_output(p, o, g, x, hd, sparse, backend)
    return y, {"S": s_new,
               "shift": _shift_update(x, n_tokens, state["shift"])}


def apply_channel_mix(p: dict, x: Tensor, state: Optional[dict] = None,
                      sparse: Optional[dict] = None, backend: str = "auto"):
    """RWKV FFN: sigmoid(W_r xr) * (W_v relu(W_k xk)^2)."""
    dt = x.dtype
    prev = _token_shift(x, state["shift"] if state else None)
    xx = (prev - x).float()
    x32 = x.float()
    xk = (x32 + xx * p["mu_k"]).to(dt)
    xr = (x32 + xx * p["mu_r"]).to(dt)
    k = apply_proj(p, xk, "cm_k", sparse, backend)
    kv = apply_proj(p, torch.square(F.relu(k)), "cm_v", sparse, backend)
    r = torch.sigmoid(apply_proj(p, xr, "cm_r", sparse, backend))
    return r * kv, {"shift": x[:, -1].float()}


def apply_channel_mix_paged(p: dict, x: Tensor, state: dict, n_tokens: Tensor,
                            sparse: Optional[dict] = None,
                            backend: str = "auto"):
    """Slot-pooled channel mix: ``apply_channel_mix``'s math, with the
    shift carry advanced to each slot's last VALID token."""
    y, _ = apply_channel_mix(p, x, state, sparse, backend)
    return y, {"shift": _shift_update(x, n_tokens, state["shift"])}


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict:
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    return {"tm": {"S": torch.zeros((batch, d // hd, hd, hd), device=device),
                   "shift": torch.zeros((batch, d), device=device)},
            "cm": {"shift": torch.zeros((batch, d), device=device)}}
