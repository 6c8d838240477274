"""GQA attention with streaming softmax, QK-norm, sliding windows, RoPE,
a ring-buffer KV cache for decode and block-paged KV pools for the
continuous-batching engine.

Port of ``repro.models.attention``. Scores and the probability-times-V
product are accumulated in f32 from compute-dtype operands, as the
reference's ``preferred_element_type=float32`` einsums do. The mask value
is -1e30, not -inf.

The decode, prefill and paged paths write the new K/V into the cache
tensors in place (the reference returns a new cache; updating in place
saves a copy of the whole cache per step). They still return the cache.

The q/k/v/o projections take an optional ``sparse`` dict of BlockCSR /
PaletteBCSR weights ({"wq"|"wk"|"wv"|"wo": ...} in (out, in) layout) that
run ``sparse_matmul`` instead of the einsum. Under a rank mesh q, k and v
are computed split where their weights are (``distributed.parallel``);
attention itself runs on the gathered heads.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import parallel
from repro_torch.kernels.paged_attention import ops as paged_kops
from repro_torch.kernels.paged_attention import ref as paged_kref
from repro_torch.models.layers import (apply_norm, apply_rope, init_norm,
                                       truncated_normal_init)
from repro_torch.sparse import ops as sparse_ops

Tensor = torch.Tensor
NEG_INF = -1e30


def init_attention(cfg: ModelConfig, generator=None, device=None) -> dict:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def init(shape):
        return truncated_normal_init(shape, 1.0, generator, device)

    p = {"wq": init((d, h, hd)), "wk": init((d, kv, hd)),
         "wv": init((d, kv, hd)), "wo": init((h, hd, d))}
    if cfg.qk_norm:
        p["q_norm"] = init_norm(hd, "rmsnorm", device)
        p["k_norm"] = init_norm(hd, "rmsnorm", device)
    return p


def _project_qkv(p: dict, x: Tensor, cfg: ModelConfig, positions: Tensor,
                 sparse: Optional[dict] = None, backend: str = "auto"):
    dt = x.dtype
    b, s = x.shape[0], x.shape[1]
    hd = cfg.resolved_head_dim

    def proj(name, n_out_heads):
        if sparse and name in sparse:
            m = sparse[name]
            fn = lambda h: sparse_ops.sparse_matmul(  # noqa: E731
                h, m, backend, dt)
            h = x.reshape(-1, x.shape[-1])
            y = (fn(h) if parallel.split_dim(m) is None
                 else parallel.col_parallel(h, fn))
            return y.reshape(b, s, n_out_heads, hd)
        w = p[name]
        fn = lambda h: torch.einsum(  # noqa: E731
            "bsd,dhk->bshk", h, w.to(dt))
        return (fn(x) if parallel.split_dim(w) is None
                else parallel.col_parallel(x, fn, dim=2))

    q = proj("wq", cfg.n_heads)
    k = proj("wk", cfg.n_kv_heads)
    v = proj("wv", cfg.n_kv_heads)
    if cfg.qk_norm:
        q = apply_norm(p["q_norm"], q, "rmsnorm")
        k = apply_norm(p["k_norm"], k, "rmsnorm")
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def chunked_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                      window: Optional[int] = None, q_chunk: int = 1024,
                      kv_chunk: int = 1024, q_offset: int = 0) -> Tensor:
    """Streaming-softmax attention; never forms the (Sq, Skv) scores.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd), H a multiple of KV (GQA).
    Returns (B, Sq, H, hd) in q's dtype. As in the reference, Sq must be a
    multiple of ``min(q_chunk, Sq)`` and Skv of ``min(kv_chunk, Skv)``."""
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = hd ** -0.5
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"sequence lengths ({sq}, {skv}) must be multiples of "
                         f"the chunks ({q_chunk}, {kv_chunk})")
    qg = q.reshape(b, sq, kv, g, hd).float()
    kf, vf = k.float(), v.float()
    dev = q.device
    outs = []
    for q0 in range(0, sq, q_chunk):
        qc = qg[:, q0:q0 + q_chunk]                    # (b, qc, kv, g, hd)
        qp = torch.arange(q0, q0 + q_chunk, device=dev) + q_offset
        m = torch.full((b, kv, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kv, g, q_chunk), device=dev)
        acc = torch.zeros((b, kv, g, q_chunk, hd), device=dev)
        for k0 in range(0, skv, kv_chunk):
            kc, vc = kf[:, k0:k0 + kv_chunk], vf[:, k0:k0 + kv_chunk]
            kp = torch.arange(k0, k0 + kv_chunk, device=dev)
            s = torch.einsum("bqkgh,bckh->bkgqc", qc, kc) * scale
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                mask &= qp[:, None] >= kp[None, :]
            if window is not None:
                mask &= (qp[:, None] - kp[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m2 = torch.maximum(m, s.amax(-1))
            pr = torch.exp(s - m2[..., None])
            corr = torch.exp(m - m2)
            l = corr * l + pr.sum(-1)
            acc = corr[..., None] * acc + torch.einsum("bkgqc,bckh->bkgqh", pr, vc)
            m = m2
        out = acc / l.clamp(min=1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))        # (b, qc, kv, g, hd)
    return torch.cat(outs, 1).reshape(b, sq, h, hd).to(q.dtype)


def _out_proj(p: dict, out: Tensor, dt, sparse: Optional[dict],
              backend: str = "auto") -> Tensor:
    """Output projection; sparse["wo"] is stored (d, heads*hd)."""
    b, s = out.shape[0], out.shape[1]
    if sparse and "wo" in sparse:
        y = sparse_ops.sparse_matmul(out.reshape(b * s, -1), sparse["wo"],
                                     backend, dt)
        return y.reshape(b, s, -1)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(dt))


def apply_attention(p: dict, x: Tensor, cfg: ModelConfig, positions: Tensor,
                    sparse: Optional[dict] = None,
                    backend: str = "auto") -> Tensor:
    """Training / prefill self-attention over a full sequence."""
    q, k, v = _project_qkv(p, x, cfg, positions, sparse, backend)
    out = chunked_attention(q, k, v, causal=True, window=cfg.attn_window)
    return _out_proj(p, out, x.dtype, sparse, backend)


# ---------------------------------------------------------------------------
# Decode (one new token against a ring KV cache)
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, seq_len: int, dtype,
                  device=None) -> dict:
    """Ring-buffer cache, window-bounded for local attention. With
    ``kv_cache_dtype='int8'`` K/V are int8 with one f32 scale per
    (batch, slot, head)."""
    size = seq_len if cfg.attn_window is None else min(cfg.attn_window, seq_len)
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (batch, size, kv, hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros((batch, size, kv, 1), device=device),
                "v_scale": torch.zeros((batch, size, kv, 1), device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_heads(x: Tensor):
    """Per-(batch, pos, head) symmetric int8 quantization."""
    x32 = x.float()
    scale = (x32.abs().amax(-1, keepdim=True) / 127.0).clamp(min=1e-12)
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale


def _dequantized(cache: dict, name: str, dtype) -> Tensor:
    return (cache[name].float() * cache[name + "_scale"]).to(dtype)


def decode_attention(p: dict, x: Tensor, cache: dict, pos: int,
                     cfg: ModelConfig, sparse: Optional[dict] = None,
                     backend: str = "auto") -> tuple[Tensor, dict]:
    """x: (B, 1, d); pos: position of the new token. Writes the new K/V
    into the cache in place and returns (y, cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, sparse, backend)

    size = cache["k"].shape[1]
    slot = pos % size
    if cfg.kv_cache_dtype == "int8":
        for name, new in (("k", k_new), ("v", v_new)):
            qn, sc = _quantize_heads(new)
            cache[name][:, slot] = qn[:, 0]
            cache[name + "_scale"][:, slot] = sc[:, 0]
        k = _dequantized(cache, "k", x.dtype)
        v = _dequantized(cache, "v", x.dtype)
    else:
        cache["k"][:, slot] = k_new[:, 0].to(cache["k"].dtype)
        cache["v"][:, slot] = v_new[:, 0].to(cache["v"].dtype)
        k, v = cache["k"], cache["v"]

    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kv
    qg = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgh,bckh->bkgc", qg, k.float()) * hd ** -0.5

    idx = torch.arange(size, device=x.device)
    written = size if pos + 1 >= size else pos + 1
    valid = idx < written
    if cfg.attn_window is not None:
        valid &= ((slot - idx) % size) < cfg.attn_window
    s = torch.where(valid, s, NEG_INF)

    pattn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgc,bckh->bkgh", pattn, v.float())
    out = out.reshape(b, 1, h, hd).to(x.dtype)
    return _out_proj(p, out, x.dtype, sparse, backend), cache


# ---------------------------------------------------------------------------
# Prefill (whole prompt in one forward, cache filled in one write)
# ---------------------------------------------------------------------------

def _write_prefill_cache(cache: dict, k: Tensor, v: Tensor,
                         cfg: ModelConfig) -> dict:
    """Write the prompt's K/V into the ring cache (slot of position p is
    ``p % size``); with a prompt longer than the ring only the last
    ``size`` positions survive, as stepwise decode would leave them."""
    size = cache["k"].shape[1]
    s = k.shape[1]
    n_keep = min(s, size)
    slots = (torch.arange(n_keep, device=k.device) + s - n_keep) % size
    for name, new in (("k", k[:, s - n_keep:]), ("v", v[:, s - n_keep:])):
        if cfg.kv_cache_dtype == "int8":
            qn, sc = _quantize_heads(new)
            cache[name][:, slots] = qn
            cache[name + "_scale"][:, slots] = sc
        else:
            cache[name][:, slots] = new.to(cache[name].dtype)
    return cache


def prefill_attention(p: dict, x: Tensor, cache: dict, positions: Tensor,
                      cfg: ModelConfig, sparse: Optional[dict] = None,
                      backend: str = "auto") -> tuple[Tensor, dict]:
    """Full-sequence attention over the prompt that also fills the cache."""
    q, k, v = _project_qkv(p, x, cfg, positions, sparse, backend)
    out = chunked_attention(q, k, v, causal=True, window=cfg.attn_window)
    y = _out_proj(p, out, x.dtype, sparse, backend)
    return y, _write_prefill_cache(cache, k, v, cfg)


# ---------------------------------------------------------------------------
# Paged attention (continuous-batching engine, serve/paged_kv.py)
# ---------------------------------------------------------------------------

def init_paged_kv(cfg: ModelConfig, n_pages: int, page_size: int, dtype,
                  device=None) -> dict:
    """Per-layer block-paged KV pool: K/V stored as (n_pages, page_size, kv,
    hd) pages shared by every request slot. Page 0 is the engine's trash
    page: never allocated to a request, so masked-out token writes land
    there harmlessly. With ``kv_cache_dtype='int8'`` pages hold int8 K/V
    plus one f32 scale per (page, offset, head)."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (n_pages, page_size, kv, hd)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros((n_pages, page_size, kv, 1),
                                       device=device),
                "v_scale": torch.zeros((n_pages, page_size, kv, 1),
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def paged_attention(p: dict, x: Tensor, cache: dict, page_table: Tensor,
                    positions: Tensor, n_tokens: Tensor, cfg: ModelConfig,
                    sparse: Optional[dict] = None, backend: str = "auto",
                    kv_splits: int = 1, sparse_backend: str = "auto"
                    ) -> tuple[Tensor, dict]:
    """Mixed prefill/decode attention against a block-paged KV pool.

    x: (B, C, d): B engine slots, up to C new tokens each; slot i carries
    ``n_tokens[i]`` valid tokens at absolute positions ``positions[i, :]``
    (decode slots 1, prefill slots a chunk, inactive slots 0). cache:
    {"k", "v"} (n_pages, page_size, kv, hd) pools; page_table: (B, P)
    physical page of each slot's logical page p (covering positions
    [p*page_size, (p+1)*page_size)), 0 for unallocated entries.

    The new K/V are written into each slot's pages first, in place
    (invalid tokens go to the trash page 0), then every query attends over
    its slot's pages under a causal-by-absolute-position mask, so one call
    serves any mix of prefill chunks and single-token decodes. Invalid
    queries read finite garbage that is discarded downstream. Returns
    (y, cache).

    ``backend`` picks the attention product: 'cuda' (the port's name for
    the reference's 'pallas') runs the hand-written paged flash-decode
    kernel (``kernels/paged_attention``; its plain version for CPU
    tensors), which never forms the gathered ``(B, P*page_size, ...)``
    context, with the page walk cut into ``kv_splits`` splits; 'ref'
    gathers the whole page table and takes the softmax; 'auto' is 'cuda'
    for a CUDA tensor and 'ref' for a CPU one. ``sparse_backend`` is the
    projections' (``sparse.ops.sparse_matmul``)."""
    b, c = x.shape[0], x.shape[1]
    ps = cache["k"].shape[1]
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, sparse,
                                   sparse_backend)

    valid = (torch.arange(c, dtype=torch.int32, device=x.device)[None, :]
             < n_tokens[:, None])
    logical = (positions // ps).clamp(0, page_table.shape[1] - 1)
    phys = torch.gather(page_table, 1, logical.long())
    phys = torch.where(valid, phys, 0).reshape(-1).long()       # trash page
    offs = (positions % ps).reshape(-1).long()
    if cfg.kv_cache_dtype == "int8":
        # quantize the new chunk per (slot, position, head) and write codes
        # and scales; the attention product runs on a pool dequantized once
        # per call, as in the reference
        for name, new in (("k", k_new), ("v", v_new)):
            qn, sc = _quantize_heads(new)
            cache[name][phys, offs] = qn.reshape(b * c, *qn.shape[2:])
            cache[name + "_scale"][phys, offs] = sc.reshape(b * c,
                                                            *sc.shape[2:])
        k_pool = _dequantized(cache, "k", x.dtype)
        v_pool = _dequantized(cache, "v", x.dtype)
    else:
        for name, new in (("k", k_new), ("v", v_new)):
            pool = cache[name]
            pool[phys, offs] = new.reshape(b * c, *new.shape[2:]).to(pool.dtype)
        k_pool, v_pool = cache["k"], cache["v"]

    if sparse_ops.resolve_backend(backend, x) == "cuda":
        out = paged_kops.paged_flash_attention(
            q, k_pool, v_pool, page_table, positions,
            window=cfg.attn_window, kv_splits=kv_splits)
    else:
        out = paged_kref.paged_attention_ref(q, k_pool, v_pool, page_table,
                                             positions, window=cfg.attn_window)
    y = _out_proj(p, out.to(x.dtype), x.dtype, sparse, sparse_backend)
    return y, cache
