"""Plain PyTorch versions of the paged flash-decode attention kernel.

``paged_attention_ref`` is the gather-then-softmax oracle of
``repro.kernels.paged_attention.ref``: it gathers the whole page table
into a dense ``(B, P*page_size, kv, hd)`` context, masks by absolute
position and takes the softmax. ``paged_flash_fwd_ref`` computes what the
kernel computes (``repro.kernels.paged_attention.paged_attention.
paged_flash_fwd``): per-KV-split UNNORMALIZED partials ``(acc, m, l)`` of
the online softmax over each split's pages, with the kernel's page-skip
predicate and its -1e30 sentinel. ``ops.py`` runs the second for tensors
on the CPU; the CPU tests hold both against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pool, v_pool, page_table, positions, *,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, C, H, hd); k/v_pool: (n_pages, ps, KV, hd);
    page_table: (B, P) int32; positions: (B, C) int32 absolute positions.

    Returns (B, C, H, hd) f32. Rows whose query is invalid (an inactive
    slot, or past a slot's ``n_tokens``) return finite garbage, as the
    kernel path does; callers discard them."""
    b, c, h, hd = q.shape
    ps, kv = k_pool.shape[1], k_pool.shape[2]
    p_log = page_table.shape[1]
    g = h // kv
    table = page_table.long()
    k_ctx = k_pool[table].reshape(b, p_log * ps, kv, hd).float()
    v_ctx = v_pool[table].reshape(b, p_log * ps, kv, hd).float()

    qg = q.reshape(b, c, kv, g, hd).float()
    s = torch.einsum("bqkgh,bckh->bkgqc", qg, k_ctx) * hd ** -0.5
    k_pos = torch.arange(p_log * ps, dtype=torch.int32, device=q.device)
    mask = k_pos[None, None, :] <= positions[:, :, None]          # (B, C, K)
    if window is not None:
        mask &= (positions[:, :, None] - k_pos[None, None, :]) < window
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    pattn = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqc,bckh->bkgqh", pattn, v_ctx)
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, h, hd)


def pages_per_split(n_logical: int, kv_splits: int) -> int:
    """Pages each split walks: ceil(P / S), with 1 <= S <= P."""
    if not 1 <= kv_splits <= n_logical:
        raise ValueError(f"kv_splits must be in [1, {n_logical}] (the page "
                         f"table's width), got {kv_splits}")
    return -(-n_logical // kv_splits)


def page_runs(page: int, start: torch.Tensor, c: int, ps: int,
              window: Optional[int]) -> torch.Tensor:
    """(B,) bool: whether logical ``page`` (inside the table) contributes
    to a slot whose tick starts at absolute position ``start``: not above
    the causal frontier of the tick's last row, not below the window floor
    of its first row."""
    run = page * ps <= start + c - 1
    if window is not None:
        run &= page * ps + ps - 1 >= start - window + 1
    return run


def paged_flash_fwd_ref(q, k_pool, v_pool, page_table, positions, start, *,
                        window: Optional[int] = None, kv_splits: int = 1):
    """Unnormalized flash-decode partials over a block-paged KV pool.

    q          : (B, KV, C, g, hd) queries grouped per kv head (f32)
    k/v_pool   : (n_pages, page_size, KV, hd) physical page pools
    page_table : (B, P) int32, physical page of each logical page
    positions  : (B, C) int32 absolute positions
    start      : (B,) int32 first absolute position of the tick

    Returns (acc, m, l): acc (B, KV, S, C, g, hd) f32 and m, l
    (B, KV, S, C, g) f32, S = kv_splits. A split whose pages all skip
    emits (m = -1e30, l = 0, acc = 0)."""
    b, kv, c, g, hd = q.shape
    ps = k_pool.shape[1]
    n_logical = page_table.shape[1]
    pp = pages_per_split(n_logical, kv_splits)
    scale = hd ** -0.5
    dev = q.device
    qf = q.float()
    table = page_table.long()
    start = start.to(torch.int32)
    arange_b = torch.arange(b, device=dev)
    accs, ms, ls = [], [], []
    for s in range(kv_splits):
        m = torch.full((b, kv, c, g), NEG_INF, device=dev)
        l = torch.zeros((b, kv, c, g), device=dev)
        acc = torch.zeros((b, kv, c, g, hd), device=dev)
        for j in range(pp):
            page = s * pp + j
            if page >= n_logical:
                break
            run = page_runs(page, start, c, ps, window)   # (B,)
            phys = table[arange_b, page]
            k = k_pool[phys].float()                     # (B, ps, KV, hd)
            v = v_pool[phys].float()
            sc = torch.einsum("bkcgh,btkh->bkcgt", qf, k) * scale
            k_pos = page * ps + torch.arange(ps, device=dev)
            q_pos = positions[:, :, None]                # (B, C, 1)
            mask = q_pos >= k_pos
            if window is not None:
                mask &= (q_pos - k_pos) < window
            sc = torch.where(mask[:, None, :, None, :], sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(-1))
            p = torch.exp(sc - m_new[..., None])
            corr = torch.exp(m - m_new)
            l_new = corr * l + p.sum(-1)
            acc_new = corr[..., None] * acc + torch.einsum(
                "bkcgt,btkh->bkcgh", p, v)
            keep = run[:, None, None, None]
            m = torch.where(keep, m_new, m)
            l = torch.where(keep, l_new, l)
            acc = torch.where(keep[..., None], acc_new, acc)
        accs.append(acc)
        ms.append(m)
        ls.append(l)
    return torch.stack(accs, 2), torch.stack(ms, 2), torch.stack(ls, 2)


def combine_splits(acc, m, l) -> torch.Tensor:
    """The exact cross-split softmax combine of ``repro.kernels.
    paged_attention.ops`` (identity at one split):

        out = sum_s exp(m_s - m*) acc_s / max(sum_s exp(m_s - m*) l_s, 1e-30)

    acc (B, KV, S, C, g, hd), m/l (B, KV, S, C, g) -> (B, KV, C, g, hd)."""
    m_star = m.amax(2)
    w = torch.exp(m - m_star[:, :, None])
    l_tot = (w * l).sum(2)
    acc_tot = (w[..., None] * acc).sum(2)
    return acc_tot / l_tot.clamp(min=1e-30)[..., None]
