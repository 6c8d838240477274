"""Top-k MoE layer with capacity-based dispatch.

Port of ``repro.models.moe``, the single-program (``gspmd``) path: the
router in f32, top-k gates renormalised, Switch-style aux losses, then
capacity dispatch into an (E, cap, d) buffer, the expert FFN over the
whole buffer, and the gated combine. The expert-parallel ``shard_map``
path needs a device mesh and comes with ROADMAP Queue 1 item 12.

Compressed experts (E-stacked BlockCSR / PaletteBCSR, one (out, in) slice
per expert) run ``sparse_matmul`` on the 3-D buffer: one launch of the
expert spmm kernel per projection for all E experts, where the reference
maps one ``sparse_matmul`` per expert. Under autograd each projection's
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
from repro_torch.models.layers import activation, truncated_normal_init
from repro_torch.sparse import ops as sparse_ops

Tensor = torch.Tensor
# what the port's message names for the expert-parallel path
_SHARD_MAP = ("the expert-parallel shard_map MoE path needs a device mesh; "
              "it comes with the multi-device slice (ROADMAP Queue 1 item 12)")


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


def _router_and_aux(router_w: Tensor, xt: Tensor, e: MoEConfig):
    """Gates (t, k) renormalised, expert ids (t, k), and the aux losses
    {load_balance, z_loss} of the f32 router on tokens xt (t, d)."""
    logits = xt.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    gate, expert_idx = _top_k(probs, e.top_k)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    me = probs.mean(0)
    ce = F.one_hot(expert_idx[:, 0], e.n_experts).float().mean(0)
    aux = {"load_balance": e.n_experts * (me * ce).sum(),
           "z_loss": e.router_z_loss * torch.logsumexp(logits, -1)
           .square().mean()}
    return gate, expert_idx, aux


def _positions(flat_e: Tensor, n_experts: int) -> Tensor:
    """int32 position of each flat (token, choice) pair among the pairs
    routed to its expert (token-major, choice-minor). The reference's
    int32 running count of the one-hot, taken over an (E, T * k) one-hot so
    that the scan runs along the contiguous axis; positions are integers,
    so the result is the reference's exactly."""
    eoh = (flat_e[None, :] == torch.arange(
        n_experts, device=flat_e.device)[:, None]).to(torch.int32)
    count = eoh.cumsum(1, dtype=torch.int32)
    return count.gather(0, flat_e[None].long())[0] - 1


def _dispatch(expert_idx: Tensor, n_experts: int, cap: int) -> Tensor:
    """Row of each flat (token, choice) pair in the (E * cap + 1, d) buffer:
    expert * cap + its position among the pairs routed to that expert
    (token-major, choice-minor), or E * cap, the overflow row, at or past
    the capacity."""
    flat_e = expert_idx.reshape(-1)
    pos = _positions(flat_e, n_experts)
    return torch.where(pos < cap, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))


def apply_moe(p: dict, x: Tensor, cfg: ModelConfig, impl: str = "auto",
              sparse: Optional[dict] = None,
              backend: str = "auto") -> tuple[Tensor, dict]:
    """x: (B, S, d) -> (B, S, d), aux losses {load_balance, z_loss}.

    ``sparse`` maps expert projection names ("ewi", "ewg", "ewo") to
    E-stacked BlockCSR / PaletteBCSR weights; those run ``sparse_matmul``
    (with ``backend``) over the whole (E, cap, in) buffer. ``impl``:
    'auto' and 'gspmd' run the single-program dispatch; 'shard_map' is not
    ported."""
    if impl == "shard_map":
        raise NotImplementedError(_SHARD_MAP)
    if impl not in ("auto", "gspmd"):
        raise ValueError(f"unknown MoE impl {impl!r}")
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
    rows = _dispatch(expert_idx, n_e, cap)
    buf = xt.new_zeros((n_e * cap + 1, d))
    buf[rows] = xt.repeat_interleave(k, dim=0)
    buf = buf[:n_e * cap].view(n_e, cap, d)

    def emm(name: str, inp: Tensor) -> Tensor:
        """(E, cap, in) x per-expert (in, out) -> (E, cap, out) in dt."""
        if sparse and name in sparse:
            return sparse_ops.sparse_matmul(inp, sparse[name], backend).to(dt)
        return torch.bmm(inp, p[name].to(dt))

    h = f(emm("ewg", buf)) * emm("ewi", buf)
    out_buf = emm("ewo", h)

    # combine: each (token, choice) reads its row (the overflow row is
    # zero), times its gate; a token's k rows are contiguous and summed
    out = torch.cat([out_buf.reshape(n_e * cap, d), out_buf.new_zeros(1, d)])
    weighted = out[rows] * gate.reshape(-1, 1).to(dt)
    y = weighted.view(t, k, d).sum(1)

    if "shared" in p:
        sp = p["shared"]
        hs = f(xt @ sp["wg"].to(dt)) * (xt @ sp["wi"].to(dt))
        y = y + hs @ sp["wo"].to(dt)
    return y.reshape(b, s, d), aux

