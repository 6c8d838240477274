"""Gradients through compressed MoE experts in the port against the JAX
package, on the CPU.

The port's ``sparse_matmul`` of a 3-D x (E, M, K) against an E-stacked
BlockCSR takes dx and the gradient of the block store through the expert
forms of ``spmm_t`` and the SDDMM (on the CPU, their plain versions: loops
of the single-matrix plain versions); the reference maps one
``sparse_matmul`` per expert (``lax.map``) and differentiates each through
its ``custom_vjp``. Weights are layer 0's expert stacks of reduced
olmoe-1b-7b (4 experts, top-2) and llama4-scout-17b-a16e (4 experts,
top-1, a shared expert), drawn and compressed by the JAX package and
carried across as numpy (``tests/torch_parity.py``); inputs and
cotangents are drawn with numpy from a seed.

Tolerance: 1e-5 of the largest |value| of each gradient. Both packages sum
the same f32 products in another order (a few roundings of 2^-24
relative each); the gradients of ``apply_moe`` pass through the gated
combine and the dispatch, a few such sums deep.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.model_zoo import build as jax_build
from repro.sparse import ops as jsparse
from repro_torch.kernels.bsr_sddmm import ops as sddmm_ops
from repro_torch.kernels.bsr_spmm import ops as kops
from repro_torch.kernels.bsr_spmm import ref as kref
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build
from repro_torch.sparse import ops as sparse_ops
from torch_parity import jax_reduced_params, to_port

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
BLOCKS = [(8, 64), (8, 16)]
PROJS = ["ewi", "ewg", "ewo"]
TOL = 1e-5
AUX_WEIGHT = 1e-2          # train/step.make_loss_fn's default, as the reference's


@functools.lru_cache(maxsize=None)
def _layer0(arch, weights, block):
    """(JAX cfg, port cfg, JAX and port layer-0 MoE dense params, JAX and
    port layer-0 compressed experts) of the reduced ``arch``; made once per
    argument set, shared read-only."""
    jm = jax_build(arch, reduced=True)
    tm = build(arch, reduced=True, device="cpu")
    jp = jax_reduced_params(jm, weights, block, seed=1)
    tp = to_port(jp)
    dense = (jp, tp) if weights == "dense" else (jp.dense, tp.dense)
    jd = jax.tree.map(lambda a: a[0], dense[0]["layers"]["b0_attn"]["moe"])
    td = {k: (v[0] if isinstance(v, torch.Tensor) else
              {kk: vv[0] for kk, vv in v.items()})
          for k, v in dense[1]["layers"]["b0_attn"]["moe"].items()}
    if weights == "dense":
        return jm.cfg, tm.cfg, jd, td, None, None
    jsp = jax.tree.map(lambda a: a[0], jp.sparse["layers"]["b0_attn"]["moe"])
    tsp = {k: v[0] for k, v in tp.sparse["layers"]["b0_attn"]["moe"].items()}
    assert sorted(tsp) == sorted(PROJS)
    return jm.cfg, tm.cfg, jd, td, jsp, tsp


def _max_scaled_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


def _jax_expert_grads(w, x, g):
    """dx and d(data) of sum(g * lax.map(sparse_matmul)) in the reference."""
    def f(data, xx):
        wd = dataclasses.replace(w, data=data)
        y = jax.lax.map(lambda wx: jsparse.sparse_matmul(wx[1], wx[0]),
                        (wd, xx))
        return jnp.sum(y * g)
    return jax.grad(f, argnums=(0, 1))(w.data, jnp.asarray(x))


@pytest.mark.parametrize("proj", PROJS)
@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_sparse_matmul_grads_match_jax(arch, block, proj):
    """dx and the gradient of the E-stacked block store, per expert slice,
    within 1e-5 of the largest |value|; M = 10 rows an expert (not a
    multiple of 16); every expert's padded slots get zero."""
    jcfg, _, _, _, jsp, tsp = _layer0(arch, "bcsr", block)
    jw, tw = jsp[proj], tsp[proj]
    e, (n, k) = tw.data.shape[0], tw.shape
    rng = np.random.default_rng(11)
    x = rng.normal(size=(e, 10, k)).astype(np.float32)
    g = rng.normal(size=(e, 10, n)).astype(np.float32)
    jdw, jdx = _jax_expert_grads(jw, x, g)
    xt = torch.tensor(x, requires_grad=True)
    data = tw.data.clone().requires_grad_(True)
    y = sparse_ops.sparse_matmul(xt, dataclasses.replace(tw, data=data))
    (y * torch.tensor(g)).sum().backward()
    for i in range(e):
        assert _max_scaled_err(xt.grad[i].numpy(), jdx[i]) <= TOL, i
        assert _max_scaled_err(data.grad[i].numpy(), jdw[i]) <= TOL, i
    _, _, valid = sddmm_ops.slot_coordinates(tw)
    assert valid.shape == tw.data.shape[:2]
    assert (data.grad[~valid] == 0).all()
    assert not bool(valid[:, 0].any())       # slot 0, the pad, of every expert


@pytest.mark.parametrize("arch", ARCHS)
def test_palette_experts_take_dx_only(arch):
    """A PaletteBCSR-8 expert stack: dx equals the reference's through the
    dequantized weight, and neither the codes nor the palette get a
    gradient."""
    _, _, _, _, jsp, tsp = _layer0(arch, "pal8", (8, 64))
    jw, tw = jsp["ewo"], tsp["ewo"]
    e, (n, k) = tw.codes.shape[0], tw.shape
    rng = np.random.default_rng(12)
    x = rng.normal(size=(e, 7, k)).astype(np.float32)
    g = rng.normal(size=(e, 7, n)).astype(np.float32)

    def f(xx):
        y = jax.lax.map(lambda wx: jsparse.sparse_matmul(wx[1], wx[0]),
                        (jw, xx))
        return jnp.sum(y * g)
    jdx = jax.grad(f)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    pal = tw.palette.clone().requires_grad_(True)
    y = sparse_ops.sparse_matmul(xt, dataclasses.replace(tw, palette=pal))
    (y * torch.tensor(g)).sum().backward()
    assert _max_scaled_err(xt.grad.numpy(), jdx) <= TOL
    assert pal.grad is None and not tw.codes.requires_grad


def _apply_moe_grads_jax(jcfg, jd, jsp, x, g):
    """Gradients of sum(g * y) + AUX_WEIGHT load_balance + z_loss through
    the reference's ``apply_moe``, w.r.t. its dense params, x and each
    compressed expert's block store."""
    datas = {k: v.data for k, v in (jsp or {}).items()}

    def f(p, xx, dd):
        sp = ({k: dataclasses.replace(v, data=dd[k]) for k, v in jsp.items()}
              if jsp else None)
        y, aux = jmoe.apply_moe(p, xx, jcfg, sparse=sp)
        return (jnp.sum(y * g) + AUX_WEIGHT * aux["load_balance"]
                + aux["z_loss"])
    return jax.grad(f, argnums=(0, 1, 2))(jd, jnp.asarray(x), datas)


def _apply_moe_grads_port(tcfg, td, tsp, x, g):
    leaves = {}

    def grad_leaf(path, t):
        leaves[path] = t.detach().clone().requires_grad_(True)
        return leaves[path]
    p = {k: (grad_leaf(k, v) if isinstance(v, torch.Tensor) else
             {kk: grad_leaf(f"{k}/{kk}", vv) for kk, vv in v.items()})
         for k, v in td.items()}
    sp = None
    if tsp:
        sp = {k: dataclasses.replace(v, data=grad_leaf(f"data/{k}", v.data))
              for k, v in tsp.items()}
    xt = grad_leaf("x", torch.tensor(x))
    y, aux = tmoe.apply_moe(p, xt, tcfg, sparse=sp)
    loss = ((y * torch.tensor(g)).sum() + AUX_WEIGHT * aux["load_balance"]
            + aux["z_loss"])
    loss.backward()
    return {k: v.grad for k, v in leaves.items()}


@pytest.mark.parametrize("capacity_factor", [None, 0.25])
@pytest.mark.parametrize("weights,block", [("dense", None), ("bcsr", (8, 64)),
                                           ("bcsr", (8, 16))])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_grads_match_jax(arch, weights, block, capacity_factor):
    """x, the router, the shared expert (llama4-scout) and the expert
    stores (dense (E, in, out) or each compressed store) through the
    router's aux losses, the dispatch, the experts and the gated combine,
    at the config's capacity factor and at 0.25, where most choices are
    dropped (and contribute no gradient through the experts). A top-1
    router is held through its aux losses alone (see below)."""
    jcfg, tcfg, jd, td, jsp, tsp = _layer0(arch, weights, block)
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=capacity_factor))
    rng = np.random.default_rng(13)
    x = rng.normal(size=(4, 16, jcfg.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    jgp, jgx, jgd = _apply_moe_grads_jax(jcfg, jd, jsp, x, g)
    got = _apply_moe_grads_port(tcfg, td, tsp, x, g)
    want = {"x": jgx, "router": jgp["router"]}
    if jcfg.moe.top_k == 1:
        # top-1: the renormalized gate is g / g = 1, whose gradient is zero
        # in exact arithmetic; each package's autograd leaves a rounding
        # residue of (1 / g - g / g^2) dL/dgate there, about 2^-24 of
        # |dL/dgate| a token, which both sum into the router's gradient in
        # their own order. The router is therefore held with a zero
        # cotangent on y: the aux losses alone, which then are its whole
        # gradient, with no residue.
        zero = np.zeros_like(g)
        want["router"] = _apply_moe_grads_jax(jcfg, jd, jsp, x, zero)[0][
            "router"]
        got["router"] = _apply_moe_grads_port(tcfg, td, tsp, x, zero)[
            "router"]
    for name in PROJS:
        want[f"data/{name}" if jsp else name] = (jgd if jsp else jgp)[name]
    if "shared" in jd:
        want.update({f"shared/{k}": v for k, v in jgp["shared"].items()})
    assert set(want) <= set(got)
    for path, w in want.items():
        assert got[path] is not None, path
        err = _max_scaled_err(got[path].numpy(), w)
        assert err <= TOL, (path, err)
    if capacity_factor is not None:        # choices were dropped
        _, idx, _ = tmoe._router_and_aux(td["router"], torch.tensor(x).reshape(
            64, -1), tcfg.moe)
        rows, _ = tmoe._dispatch(idx, tcfg.moe.n_experts, 8)
        assert int((rows == tcfg.moe.n_experts * 8).sum()) > 0


@pytest.mark.parametrize("block", BLOCKS)
def test_expert_plain_versions_are_loops_of_single_ones(block):
    """The expert plain versions, and the expert wrappers on CPU tensors,
    equal a loop of the single-matrix plain versions over the experts
    exactly, and launch nothing; the mask of valid slots is each expert's
    own."""
    _, _, _, _, _, tsp = _layer0("olmoe-1b-7b", "bcsr", block)
    w = tsp["ewo"]
    e, (n, k) = w.data.shape[0], w.shape
    rng = np.random.default_rng(14)
    x = torch.tensor(rng.normal(size=(e, 9, k)).astype(np.float32))
    dy = torch.tensor(rng.normal(size=(e, 9, n)).astype(np.float32))
    dx = torch.stack([kref.spmm_bwd_ref(dy[i], w[i]) for i in range(e)])
    dw = torch.stack([sddmm_ops.bsr_weight_grad_ref(x[i], dy[i], w[i])
                      for i in range(e)])
    kops.reset_launches()
    sddmm_ops.reset_launches()
    assert torch.equal(kref.spmm_experts_bwd_ref(dy, w), dx)
    assert torch.equal(kops.spmm_t_experts(dy, w), dx)
    assert torch.equal(sddmm_ops.bsr_weight_grad_experts_ref(x, dy, w), dw)
    assert torch.equal(sddmm_ops.bsr_weight_grad_experts(x, dy, w), dw)
    assert not any(kops.launches.values())
    assert not any(sddmm_ops.launches.values())
    rows, cols, valid = sddmm_ops.slot_coordinates(w)
    for i in range(e):
        ri, ci, vi = sddmm_ops.slot_coordinates(w[i])
        assert torch.equal(rows[i], ri) and torch.equal(cols[i], ci)
        assert torch.equal(valid[i], vi)
    with pytest.raises(ValueError, match="3-D"):
        kops.spmm_t_experts(dy[0], w)
    with pytest.raises(ValueError, match="3-D"):
        sddmm_ops.bsr_weight_grad_experts(x[0], dy[0], w)
