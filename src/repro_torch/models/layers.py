"""Shared model layers: init, norms, embedding, head, MLP, RoPE.

Port of ``repro.models.layers``. Plain functions on tensors with the JAX
package's weight layouts. Params are f32 master weights; compute runs in
the config's compute dtype with the reference's precision at each product:
  * dense projection einsums return the compute dtype;
  * the head returns f32 logits: the compute-dtype-rounded operands are
    multiplied in f32 (JAX's ``preferred_element_type=float32``).

``apply_mlp`` and ``apply_head`` take an optional map of BlockCSR /
PaletteBCSR weights in (out, in) layout; an entry there runs
``sparse_matmul`` instead of the dense product.

Under a rank mesh a weight that ``distributed.parallel`` marks computed
split gives this rank's slice of the product, gathered over the model
group (``col_parallel``); a vocab-split embedding looks up its own rows
and sums them over the group.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import parallel
from repro_torch.sparse import ops as sparse_ops

Tensor = torch.Tensor
_MEMO_LOCK = threading.Lock()


def truncated_normal_init(shape, scale: float, generator=None, device=None,
                          dtype=torch.float32) -> Tensor:
    """He-style fan-in init: std = sqrt(scale / fan_in) times a standard
    normal truncated at +-2. As in the reference, ``fan_in = shape[0]`` (so
    attention ``wo (h, hd, d)`` has fan-in ``h``)."""
    fan_in = shape[0] if len(shape) >= 2 else max(shape[-1], 1)
    std = (scale / fan_in) ** 0.5
    t = torch.empty(shape, dtype=dtype, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(d: int, kind: str = "rmsnorm", device=None) -> dict:
    p = {"scale": torch.ones(d, device=device)}
    if kind == "layernorm":
        p["norm_bias"] = torch.zeros(d, device=device)
    return p


def apply_norm(p: dict, x: Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> Tensor:
    """Normalize in f32, apply the scale in f32, then cast back."""
    x32 = x.float()
    if kind == "rmsnorm":
        var = (x32 * x32).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * p["scale"]
    elif kind == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, unbiased=False, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["norm_bias"]
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(vocab: int, d: int, generator=None, device=None) -> dict:
    return {"embedding": truncated_normal_init((vocab, d), 1.0, generator,
                                               device)}


def apply_embed(p: dict, tokens: Tensor, compute_dtype) -> Tensor:
    """Rows of the embedding in the compute dtype. The reference casts the
    whole table and then gathers; gathering first and casting the rows
    gives the same numbers without touching the rest of the table."""
    emb = p["embedding"]
    ids = tokens.reshape(-1)
    if parallel.split_dim(emb) == 0:
        # this rank's vocab rows: the others' tokens read a zero row, and
        # the sum over the group adds exact zeros to each token's row
        n = emb.shape[0]
        local = ids - parallel.model_index() * n
        mine = (local >= 0) & (local < n)
        rows = torch.index_select(emb, 0, torch.where(mine, local, 0))
        rows = parallel.sum_model(rows * mine[:, None].to(rows.dtype))
    else:
        rows = torch.index_select(emb, 0, ids)
    return rows.reshape(*tokens.shape, emb.shape[-1]).to(compute_dtype)


def _rounded_f32(w: Tensor, dtype) -> Tensor:
    """``w`` rounded to ``dtype`` and held in f32: the operand a
    ``dtype`` einsum with f32 accumulation multiplies.

    For the (vocab, d) head table this rounded copy is made once and kept
    on the table itself while the table is unmodified, so a decode step
    does not read and re-write the whole table (189 MB at smollm-360m's
    width) to round it again. Router replicas share the table from
    threads, each on its own CUDA stream: the memo is made under a lock,
    and on the card an event recorded after it orders every reader's
    stream behind the stream that wrote it."""
    if dtype == torch.float32:
        return w.float()
    if (w.requires_grad and torch.is_grad_enabled()) or w.is_inference():
        # training: no memo in the graph; an inference tensor (a rank's
        # gathered table, made anew each pass) keeps no version to key on
        return w.to(dtype).float()
    key = (dtype, w._version)
    with _MEMO_LOCK:
        memo = getattr(w, "_repro_rounded_f32", None)
        if memo is None or memo[0] != key:
            rounded = w.to(dtype).float()
            written = None
            if rounded.is_cuda:
                written = torch.cuda.Event()
                written.record()
            memo = (key, rounded, written)
            w._repro_rounded_f32 = memo
    if memo[2] is not None:
        torch.cuda.current_stream(w.device).wait_event(memo[2])
    return memo[1]


def apply_head(p: dict, x: Tensor, tie: bool, softcap: Optional[float],
               sparse_weights: Optional[dict] = None,
               backend: str = "auto") -> Tensor:
    """f32 logits. Tied: ``x @ embedding.T``; untied: ``x @ head``; a
    compressed head (vocab, d) runs ``sparse_matmul`` on f32 input."""
    if sparse_weights and "head" in sparse_weights:
        xs = x.reshape(-1, x.shape[-1]).float()
        w = sparse_weights["head"]
        logits = _split_product(
            xs, w, lambda h: sparse_ops.sparse_matmul(h, w, backend))
        logits = logits.reshape(*x.shape[:-1], -1)
    else:
        table = p["embedding"] if tie else p["head"]
        w = _rounded_f32(table, x.dtype)
        logits = _split_product(x.float(), table,
                                lambda h: h @ (w.T if tie else w))
    if softcap:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def apply_proj(p: dict, x: Tensor, name: str,
               sparse: Optional[dict] = None, backend: str = "auto",
               f32: bool = False) -> Tensor:
    """y = x @ p[name] for a stored 2D (in, out) projection, in x's dtype,
    or with ``f32`` the f32 product of x and the weight in x's dtype,
    unrounded. A BlockCSR / PaletteBCSR entry in ``sparse`` (stored (out,
    in)) runs ``sparse_matmul`` instead: the dense-or-compressed dispatch
    of the RWKV time / channel mix and the RG-LRU block."""
    if sparse and name in sparse:
        m = sparse[name]
        dt = torch.float32 if f32 else x.dtype
        y = _split_product(x.reshape(-1, x.shape[-1]), m,
                           lambda h: sparse_ops.sparse_matmul(h, m, backend,
                                                              dt))
        return y.reshape(*x.shape[:-1], -1)
    w = p[name].to(x.dtype)
    return _split_product(x, p[name], lambda h: h.float() @ w.float()
                          if f32 else h @ w)


def _split_product(x: Tensor, w, fn) -> Tensor:
    """``fn(x)``, the product of x and the weight ``w``: gathered over the
    model group when ``w`` is computed split (its output dim, the last of
    the product)."""
    if parallel.split_dim(w) is None:
        return fn(x)
    return parallel.col_parallel(x, fn)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def activation(name: str):
    if name == "silu":
        return F.silu
    if name == "gelu":
        return lambda x: F.gelu(x, approximate="tanh")   # jax.nn.gelu default
    if name == "relu2":
        return lambda x: torch.square(F.relu(x))
    if name == "relu":
        return F.relu
    if name == "sigmoid":
        return torch.sigmoid
    raise ValueError(name)


# ---------------------------------------------------------------------------
# MLP (gated / plain), with an optional compressed path
# ---------------------------------------------------------------------------

def init_mlp(d: int, ff: int, gated: bool, generator=None, device=None) -> dict:
    p = {"wi": truncated_normal_init((d, ff), 2.0, generator, device),
         "wo": truncated_normal_init((ff, d), 2.0, generator, device)}
    if gated:
        p["wg"] = truncated_normal_init((d, ff), 2.0, generator, device)
    return p


def apply_mlp(p: dict, x: Tensor, act: str, gated: bool,
              sparse_weights: Optional[dict] = None,
              backend: str = "auto") -> Tensor:
    f = activation(act)

    def mm(name, h):
        return apply_proj(p, h, name, sparse_weights, backend)

    h = mm("wi", x)
    if gated:
        h = f(mm("wg", x)) * h
    else:
        h = f(h)
    return mm("wo", h)


# ---------------------------------------------------------------------------
# RoPE (half-split, not interleaved)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., :, None].float() * freqs       # (..., S, hd/2)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    y = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return y.to(x.dtype)
