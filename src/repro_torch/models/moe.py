"""Top-k MoE layer with capacity-based dispatch.

Port of ``repro.models.moe``. The single-program (``gspmd``) path: the
router in f32, top-k gates renormalised, Switch-style aux losses, then
capacity dispatch into an (E, cap, d) buffer, the expert FFN over the
whole buffer, and the gated combine. Under a rank mesh whose "model" axis
divides E, dense experts take the expert-parallel (``shard_map``) path of
the reference: each rank of a model group holds E / M experts (their
"embed" dim gathered over "data"), dispatches only the choices routed to
them at a per-data-shard capacity, and the outputs are summed over the
group; the aux statistics are averaged over the batch axes. Compressed
experts always take the single-program dispatch, their projections
computed split by block rows (``distributed.parallel``), and under data
parallelism that dispatch runs over the whole batch, gathered from every
data shard, as the reference's does under GSPMD.

Compressed experts (E-stacked BlockCSR / PaletteBCSR, one (out, in) slice
per expert) run ``sparse_matmul`` on the 3-D buffer: one launch of the
expert spmm kernel per projection for all E experts, where the reference
maps one ``sparse_matmul`` per expert. The launch takes each expert's
count of occupied rows (the dispatch's running count, capped at the
capacity; an (E,) int32 tensor that stays on the device) and computes
those rows only: the buffer's other rows are zero for ewi / ewg, f(0) * 0
= 0 for ewo, and the combine never reads them, so the outputs are the
reference's, which computes every row. Under autograd each projection's
backward is one launch of the expert ``spmm_t`` (dx) and one of the expert
SDDMM (dw at each expert's resident slots; a palette store takes dx
only). Dense experts run ``torch.bmm``. The dispatch is a scatter into the
buffer and the combine a gather from it, so a dropped (token, choice)
gets no gradient through the experts, as in the reference.

Ties and order, kept from the reference so the same tokens are kept and
dropped:
  * the top k take the lower expert index first among equal probs
    (``lax.top_k``): a stable descending sort, then the first k;
  * positions within an expert count the flat (token, choice) pairs
    token-major, choice-minor; a choice at or past the capacity goes to an
    overflow row that is thrown away;
  * each token's k contributions are summed in x's dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.distributed import parallel
from repro_torch.distributed.sharding import current_mesh
from repro_torch.models.layers import (activation, apply_proj,
                                       truncated_normal_init)
from repro_torch.sparse import ops as sparse_ops

Tensor = torch.Tensor


def init_moe(cfg: ModelConfig, gen=None, device=None) -> dict:
    """Router, expert stacks ewi / ewg (E, d, ff) and ewo (E, ff, d), and
    the dense shared expert where the config has one, in the reference's
    layout and init scales."""
    e = cfg.moe
    d, ff = cfg.d_model, e.d_ff_expert
    p = {
        "router": truncated_normal_init((d, e.n_experts), 1.0, gen, device),
        "ewi": truncated_normal_init((e.n_experts, d, ff), 2.0, gen, device),
        "ewg": truncated_normal_init((e.n_experts, d, ff), 2.0, gen, device),
        "ewo": truncated_normal_init((e.n_experts, ff, d), 2.0, gen, device),
    }
    if e.n_shared_experts:
        sff = ff * e.n_shared_experts
        p["shared"] = {
            "wi": truncated_normal_init((d, sff), 2.0, gen, device),
            "wg": truncated_normal_init((d, sff), 2.0, gen, device),
            "wo": truncated_normal_init((sff, d), 2.0, gen, device),
        }
    return p


def _capacity(n_tokens: int, e: MoEConfig) -> int:
    """Slots per expert: capacity_factor * tokens * k / E, rounded up to a
    multiple of 8 and at least 8, as the reference pads it."""
    c = int(e.capacity_factor * n_tokens * e.top_k / e.n_experts)
    return max(8, -(-c // 8) * 8)


def _top_k(probs: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """(values, indices) of the k largest probs per row, the lower index
    first among equal values, as ``lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def _router_stats(router_w: Tensor, xt: Tensor, e: MoEConfig):
    """Gates (t, k) renormalised, expert ids (t, k), and the statistics of
    the aux losses (mean probs, top-1 share, mean squared logsumexp) of
    the f32 router on tokens xt (t, d)."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = _top_k(probs, e.top_k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(0)
    ce = F.one_hot(expert_idx[:, 0], e.n_experts).float().mean(0)
    z = torch.logsumexp(logits, -1).square().mean()
    return gate, expert_idx, me, ce, z


def _aux(me: Tensor, ce: Tensor, z: Tensor, e: MoEConfig) -> dict:
    return {"load_balance": e.n_experts * (me * ce).sum(),
            "z_loss": e.router_z_loss * z}


def _router_and_aux(router_w: Tensor, xt: Tensor, e: MoEConfig):
    """Gates, expert ids and the aux losses {load_balance, z_loss}."""
    gate, expert_idx, me, ce, z = _router_stats(router_w, xt, e)
    return gate, expert_idx, _aux(me, ce, z, e)


def _positions(flat_e: Tensor, n_experts: int) -> tuple[Tensor, Tensor]:
    """int32 position of each flat (token, choice) pair among the pairs
    routed to its expert (token-major, choice-minor), and the (E,) int32
    count of pairs routed to each expert. The reference's int32 running
    count of the one-hot, taken over an (E, T * k) one-hot so that the scan
    runs along the contiguous axis; positions are integers, so the result
    is the reference's exactly."""
    eoh = (flat_e[None, :] == torch.arange(
        n_experts, device=flat_e.device)[:, None]).to(torch.int32)
    count = eoh.cumsum(1, dtype=torch.int32)
    return count.gather(0, flat_e[None].long())[0] - 1, count[:, -1]


def _dispatch(expert_idx: Tensor, n_experts: int,
              cap: int) -> tuple[Tensor, Tensor]:
    """Row of each flat (token, choice) pair in the (E * cap + 1, d) buffer:
    expert * cap + its position among the pairs routed to that expert
    (token-major, choice-minor), or E * cap, the overflow row, at or past
    the capacity; and the occupied rows of each expert's cap, (E,) int32
    on the device (its pairs, at most cap): the buffer's rows past them
    stay zero."""
    flat_e = expert_idx.reshape(-1)
    pos, count = _positions(flat_e, n_experts)
    rows = torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return rows, count.clamp(max=cap)


def _shared_expert(p: dict, xt: Tensor, f) -> Tensor:
    sp = p["shared"]
    return apply_proj(sp, f(apply_proj(sp, xt, "wg"))
                      * apply_proj(sp, xt, "wi"), "wo")


def apply_moe(p: dict, x: Tensor, cfg: ModelConfig, impl: str = "auto",
              sparse: Optional[dict] = None,
              backend: str = "auto") -> tuple[Tensor, dict]:
    """x: (B, S, d) -> (B, S, d), aux losses {load_balance, z_loss}.

    ``sparse`` maps expert projection names ("ewi", "ewg", "ewo") to
    E-stacked BlockCSR / PaletteBCSR weights; those run ``sparse_matmul``
    (with ``backend``) over the whole (E, cap, in) buffer. ``impl``:
    'gspmd' the single-program dispatch, 'shard_map' the expert-parallel
    path (a rank mesh with a "model" axis), 'auto' the latter for dense
    experts where a mesh's "model" axis divides E, as the reference
    picks."""
    if impl not in ("auto", "gspmd", "shard_map"):
        raise ValueError(f"unknown MoE impl {impl!r}")
    mesh = current_mesh()
    if sparse:
        if impl == "shard_map":
            raise ValueError("compressed (BCSR) experts serve through the "
                             "gspmd dispatch; shard_map EP does not support "
                             "sparse expert weights")
        return _apply_moe_gspmd(p, x, cfg, sparse, backend)
    if impl == "auto":
        use_ep = (mesh is not None and "model" in mesh.shape
                  and cfg.moe.n_experts % mesh.shape["model"] == 0)
        impl = "shard_map" if use_ep else "gspmd"
    if impl == "shard_map":
        if mesh is None or "model" not in mesh.shape:
            raise ValueError("the expert-parallel MoE path needs a rank mesh "
                             "with a 'model' axis (distributed.sharding."
                             "use_mesh)")
        return _apply_moe_ep(p, x, cfg)
    return _apply_moe_gspmd(p, x, cfg, None, backend)


def _apply_moe_gspmd(p: dict, x: Tensor, cfg: ModelConfig,
                     sparse: Optional[dict],
                     backend: str) -> tuple[Tensor, dict]:
    if parallel.batch_split():
        # the dispatch and its capacity cover the whole batch, as under
        # GSPMD: every data shard's rows, then this shard's rows back
        whole = parallel.gather_batch(x)
        with parallel.whole_batch():
            y, aux = _apply_moe_gspmd(p, whole, cfg, sparse, backend)
        return parallel.batch_rows(y), aux
    e = cfg.moe
    b, s, d = x.shape
    t, k, n_e = b * s, e.top_k, e.n_experts
    cap = _capacity(t, e)
    dt = x.dtype
    f = activation(cfg.act)

    xt = x.reshape(t, d)
    gate, expert_idx, aux = _router_and_aux(p["router"], xt, e)

    # dispatch: one row per kept (token, choice); the overflow row (the
    # only one that may be written twice) is thrown away
    rows, occupied = _dispatch(expert_idx, n_e, cap)
    buf = xt.new_zeros((n_e * cap + 1, d))
    buf[rows] = xt.repeat_interleave(k, dim=0)
    buf = buf[:n_e * cap].view(n_e, cap, d)

    def emm(name: str, inp: Tensor) -> Tensor:
        """(E, cap, in) x per-expert (in, out) -> (E, cap, out) in dt."""
        if sparse and name in sparse:
            w = sparse[name]
            fn = lambda h: sparse_ops.sparse_matmul(  # noqa: E731
                h, w, backend, dt, occupied)
        else:
            w = p[name]
            fn = lambda h: torch.bmm(h, w.to(dt))  # noqa: E731
        if parallel.split_dim(w) is None:
            return fn(inp)
        return parallel.col_parallel(inp, fn)

    h = f(emm("ewg", buf)) * emm("ewi", buf)
    out_buf = emm("ewo", h)

    # combine: each (token, choice) reads its row (the overflow row is
    # zero), times its gate; a token's k rows are contiguous and summed
    out = torch.cat([out_buf.reshape(n_e * cap, d), out_buf.new_zeros(1, d)])
    weighted = out[rows] * gate.reshape(-1, 1).to(dt)
    y = weighted.view(t, k, d).sum(1)

    if "shared" in p:
        y = y + _shared_expert(p, xt, f)
    return y.reshape(b, s, d), aux


def _apply_moe_ep(p: dict, x: Tensor, cfg: ModelConfig) -> tuple[Tensor,
                                                                  dict]:
    """The expert-parallel path (``repro.models.moe._apply_moe_shard_map``)
    on this rank's experts and this data shard's tokens."""
    e = cfg.moe
    b, s, d = x.shape
    t, k = b * s, e.top_k
    dt = x.dtype
    f = activation(cfg.act)
    cap = _capacity(t, e)                   # this data shard's tokens
    split = parallel.split_dim(p["ewi"]) == 0
    e_loc = p["ewi"].shape[0]
    col = parallel.model_index() if split else 0

    xt = x.reshape(t, d)
    gate, expert_idx, me, ce, z = _router_stats(p["router"], xt, e)
    if split:
        # each rank combines only its experts' outputs: the gradients of
        # the gates and of the dispatched tokens are summed over the group
        gate = parallel.sum_grad_model(gate)
        xd = parallel.sum_grad_model(xt)
    else:
        xd = xt
    flat_e = expert_idx.reshape(-1)
    is_local = (flat_e // e_loc) == col
    le = torch.where(is_local, flat_e % e_loc, torch.full_like(flat_e, e_loc))
    pos, _ = _positions(le, e_loc + 1)
    keep = is_local & (pos < cap)
    rows = torch.where(keep, le * cap + pos,
                       torch.full_like(pos, e_loc * cap))
    buf = xd.new_zeros((e_loc * cap + 1, d))
    buf[rows] = xd.repeat_interleave(k, dim=0)
    buf = buf[:e_loc * cap].view(e_loc, cap, d)

    h = (f(torch.bmm(buf, p["ewg"].to(dt)))
         * torch.bmm(buf, p["ewi"].to(dt)))
    out_buf = torch.bmm(h, p["ewo"].to(dt))
    out = torch.cat([out_buf.reshape(e_loc * cap, d), out_buf.new_zeros(1, d)])
    weighted = out[rows] * (gate.reshape(-1) * keep).reshape(-1, 1).to(dt)
    y = weighted.view(t, k, d).sum(1)
    if split:
        y = parallel.sum_model(y)
    me, ce, z = (parallel.mean_batch(v) for v in (me, ce, z))
    if "shared" in p:
        y = y + _shared_expert(p, xt, f)
    return y.reshape(b, s, d), _aux(me, ce, z, e)
