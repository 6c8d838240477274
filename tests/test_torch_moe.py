"""The port's MoE layer (``repro_torch.models.moe``) against
``repro.models.moe`` on the CPU, and the MoE models served through the
port's ``generate`` and engine against the JAX package's.

Inputs are drawn with numpy from a seed; weights are drawn by the JAX
package and carried across as numpy (``tests/torch_parity.py``). Reduced
olmoe-1b-7b (4 experts, top-2) and reduced llama4-scout-17b-a16e (4
experts, top-1, a dense shared expert) run in f32, with dense, BlockCSR
and PaletteBCSR-8 experts (E-stacked stores, one slice per expert). The JAX
oracle runs its plain ('ref') sparse path on the CPU.

Tolerance: 1e-5 of the largest |y| on the outputs of one layer, and 1e-5
relative on its aux losses: the two packages sum the same f32 products in
another order, a few f32 roundings (2^-24 relative each) apart on outputs
of up to |y| ~ 30. The 1e-4 of ``torch_parity.check_logits_match`` holds
on logits through the whole model. Token ids and run statistics must be identical. A dropped token
(capacity_factor 0.25) must be dropped by both, which the output shows: a
dropped choice contributes zero.
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
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro_torch.distributed.sharding import use_mesh
from repro_torch.kernels.bsr_spmm import ops as kops
from repro_torch.kernels.bsr_spmm import ref as kref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build
from repro_torch.serve import api
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.step import generate
from repro_torch.sparse import ops as sparse_ops
from torch_parity import jax_reduced_params, to_port

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
FORMATS = [("dense", None), ("bcsr", (8, 64)), ("pal8", (8, 64))]
ATOL = 1e-5


def _layer0_jax(tree):
    return jax.tree.map(lambda a: a[0], tree)


def _layer0_port(tree):
    if isinstance(tree, dict):
        return {k: _layer0_port(v) for k, v in tree.items()}
    return tree[0]


@functools.lru_cache(maxsize=None)
def _moe_params(arch, weights, block, seed=1):
    """(JAX cfg, port cfg, JAX layer-0 MoE params and compressed experts,
    the port's) of the reduced ``arch``; made once per argument set and
    shared (read only) by the tests."""
    jm = jax_build(arch, reduced=True)
    tm = build(arch, reduced=True, device="cpu")
    jp = jax_reduced_params(jm, weights, block, seed=seed)
    tp = to_port(jp)
    if weights == "dense":
        return (jm.cfg, tm.cfg,
                _layer0_jax(jp["layers"]["b0_attn"]["moe"]), None,
                _layer0_port(tp["layers"]["b0_attn"]["moe"]), None)
    jsp = _layer0_jax(jp.sparse["layers"]["b0_attn"]["moe"])
    tsp = _layer0_port(tp.sparse["layers"]["b0_attn"]["moe"])
    assert sorted(tsp) == ["ewg", "ewi", "ewo"]
    return (jm.cfg, tm.cfg,
            _layer0_jax(jp.dense["layers"]["b0_attn"]["moe"]), jsp,
            _layer0_port(tp.dense["layers"]["b0_attn"]["moe"]), tsp)


def _check_moe(jcfg, tcfg, jp, jsp, tp, tsp, x):
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, sparse=jsp)
    ty, taux = tmoe.apply_moe(tp, torch.tensor(x), tcfg, sparse=tsp)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy,
                               atol=ATOL * float(np.abs(jy).max()))
    for k in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]), rtol=ATOL,
                                   err_msg=k)
    return ty


@pytest.mark.parametrize("weights,block", FORMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, weights, block):
    """One MoE layer on (4, 16) tokens, the config's capacity factor."""
    jcfg, tcfg, jp, jsp, tp, tsp = _moe_params(arch, weights, block)
    x = np.random.default_rng(2).normal(size=(4, 16, jcfg.d_model)) \
        .astype(np.float32)
    _check_moe(jcfg, tcfg, jp, jsp, tp, tsp, x)


@pytest.mark.parametrize("weights,block", FORMATS)
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_drops_what_jax_drops(arch, weights, block):
    """capacity_factor 0.25: 8 slots per expert for 64 tokens x k choices,
    so most choices overflow; which ones are kept (token-major positions)
    decides the output."""
    jcfg, tcfg, jp, jsp, tp, tsp = _moe_params(arch, weights, block)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=0.25))
    tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, capacity_factor=0.25))
    x = np.random.default_rng(3).normal(size=(4, 16, jcfg.d_model)) \
        .astype(np.float32)
    assert tmoe._capacity(64, tcfg.moe) == 8
    y = _check_moe(jcfg, tcfg, jp, jsp, tp, tsp, x)
    # some token lost a choice: without a shared expert, a token that lost
    # all its choices comes out zero
    _, idx, _ = tmoe._router_and_aux(tp["router"], torch.tensor(x).reshape(
        64, -1), tcfg.moe)
    rows, _ = tmoe._dispatch(idx, tcfg.moe.n_experts, 8)
    assert int((rows == tcfg.moe.n_experts * 8).sum()) > 0
    if "shared" not in tp:
        lost = (rows == tcfg.moe.n_experts * 8).view(64, -1).all(1)
        assert bool(lost.any())
        assert float(y.reshape(64, -1)[lost].abs().max()) == 0.0


def test_top_k_breaks_ties_as_lax_top_k():
    """Equal probs: the lower expert index first, as ``lax.top_k``."""
    rng = np.random.default_rng(5)
    p = rng.random((64, 8)).astype(np.float32)
    p[:, 3] = p[:, 1]
    p[:, 6] = p[:, 1]
    p[::3, 0] = p[::3, 1]
    for k in (1, 2, 3, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(p), k)
        tv, ti = tmoe._top_k(torch.tensor(p), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_tied_router_matches_jax():
    """A router whose experts 1 and 2 have the same column: every token's
    probs tie between them, and the choices, positions and output follow
    the reference's tie-break."""
    jcfg, tcfg, jp, jsp, tp, tsp = _moe_params("olmoe-1b-7b", "bcsr", (8, 64))
    r = np.asarray(jp["router"]).copy()
    r[:, 2] = r[:, 1]
    jp = dict(jp, router=jnp.asarray(r))
    tp = dict(tp, router=torch.tensor(r))
    x = np.random.default_rng(6).normal(size=(2, 16, jcfg.d_model)) \
        .astype(np.float32)
    _check_moe(jcfg, tcfg, jp, jsp, tp, tsp, x)


@pytest.mark.parametrize("capacity", [8, 40])
@pytest.mark.parametrize("n_experts,k", [(4, 2), (64, 8), (16, 1)])
def test_capacity_and_dispatch_match_jax(capacity, n_experts, k):
    """``_capacity`` for token counts around its pad to 8, and the rows
    ``_dispatch`` gives each (token, choice) against the reference's slot
    arithmetic (``moe.py:235-240``)."""
    for t in (1, 4, 16, 31, 64, 256):
        for cf in (0.25, 1.25, 8.0):
            e = tmoe.MoEConfig(n_experts, k, 8, capacity_factor=cf)
            assert tmoe._capacity(t, e) == jmoe._capacity(t, e)
    rng = np.random.default_rng(capacity + n_experts)
    idx = np.stack([rng.permutation(n_experts)[:k] for _ in range(64)])
    flat = idx.reshape(-1)
    eoh = np.eye(n_experts, dtype=np.int64)[flat]
    pos = (np.cumsum(eoh, 0) * eoh).sum(-1) - 1
    want = np.where(pos < capacity, flat * capacity + pos,
                    n_experts * capacity)
    got, _ = tmoe._dispatch(torch.tensor(idx), n_experts, capacity)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights", ["bcsr", "pal8"])
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_expert_plain_version_is_a_loop_of_single_calls(weights, backend):
    """``sparse_matmul`` of a 3-D x on E-stacked experts (on the CPU: the
    experts' plain version, reached through the 'ref' path and through the
    kernel wrapper) equals a loop of single-expert ``sparse_matmul``
    calls."""
    _, tcfg, _, _, _, tsp = _moe_params("olmoe-1b-7b", weights, (8, 64))
    w = tsp["ewi"]
    x = torch.tensor(np.random.default_rng(7).normal(
        size=(tcfg.moe.n_experts, 9, tcfg.d_model)).astype(np.float32))
    got = sparse_ops.sparse_matmul(x, w, backend)
    want = torch.stack([sparse_ops.sparse_matmul(x[e], w[e], backend)
                        for e in range(x.shape[0])])
    assert got.shape == (tcfg.moe.n_experts, 9, tcfg.moe.d_ff_expert)
    assert torch.equal(got, want)
    plain = (kref.spmm_palette_experts_fwd_ref if weights == "pal8"
             else kref.spmm_experts_fwd_ref)
    torch.testing.assert_close(got.float(), plain(x, w), atol=0, rtol=0)


def test_cpu_expert_wrapper_launches_nothing():
    """On CPU tensors the expert wrappers run the plain version and count
    no launch (a launch is counted only where a kernel runs)."""
    _, tcfg, _, _, _, tsp = _moe_params("olmoe-1b-7b", "bcsr", (8, 64))
    kops.reset_launches()
    x = torch.zeros(tcfg.moe.n_experts, 3, tcfg.d_model)
    kops.spmm_experts(x, tsp["ewi"])
    assert not any(kops.launches.values())
    assert not any(kops.variant_launches.values())
    with pytest.raises(ValueError, match="3-D"):
        kops.spmm_experts(x[0], tsp["ewi"])


def test_dense_experts_train_through_autograd():
    """Dense experts take gradients (plain ``torch.bmm``), and the aux
    losses of ``apply_train`` are the sum over layers of the reference's."""
    jm = jax_build("olmoe-1b-7b", reduced=True)
    tm = build("olmoe-1b-7b", reduced=True, device="cpu")
    jp = jm.init(jax.random.PRNGKey(3))
    tp = to_port(jp)
    prompt = np.random.default_rng(8).integers(0, jm.cfg.vocab, (2, 8)) \
        .astype(np.int32)
    _, jaux = jm.apply_train(jp, {"inputs": jnp.asarray(prompt)})
    for leaf in tp["layers"]["b0_attn"]["moe"].values():
        if isinstance(leaf, torch.Tensor):
            leaf.requires_grad_(True)
    logits, taux = tm.apply_train(tp, {"inputs": torch.tensor(prompt)})
    for k in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-5, err_msg=k)
    assert float(taux["load_balance"]) > 0
    (logits.sum() + taux["load_balance"]).backward()
    g = tp["layers"]["b0_attn"]["moe"]["ewi"].grad
    assert g is not None and bool(torch.isfinite(g).all()) and \
        float(g.abs().max()) > 0


def test_shard_map_impl_names_item_12():
    """The expert-parallel path: it needs a rank mesh; on a one-rank mesh
    (no collective runs) its dispatch, at one data shard's capacity,
    equals the single-program path's, dropped tokens included; compressed
    experts keep the single-program dispatch, as in the reference."""
    _, tcfg, _, _, moe_p, _ = _moe_params("olmoe-1b-7b", "dense", None)
    x = torch.randn(2, 8, tcfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    with pytest.raises(ValueError, match="needs a rank mesh"):
        tmoe.apply_moe(moe_p, x, tcfg, impl="shard_map")
    one = mesh_lib.Mesh(shape={"data": 1, "model": 1}, rank=0,
                        coords={"data": 0, "model": 0}, groups={},
                        device=torch.device("cpu"), backend="none")
    with torch.no_grad():
        y, aux = tmoe.apply_moe(moe_p, x, tcfg, impl="gspmd")
        with use_mesh(one):
            y_ep, aux_ep = tmoe.apply_moe(moe_p, x, tcfg)
    torch.testing.assert_close(y_ep, y, atol=1e-6, rtol=0)
    for k in aux:
        torch.testing.assert_close(aux_ep[k], aux[k])
    with pytest.raises(ValueError, match="gspmd dispatch"):
        tmoe.apply_moe(moe_p, x, tcfg, impl="shard_map",
                       sparse={"ewi": object()})


# ---------------------------------------------------------------------------
# generate and the engine
# ---------------------------------------------------------------------------

GEN = 4


def _prompts(lens, vocab, seed=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _no_drop(model):
    """The same model with capacity_factor E / top_k: every expert then
    has a slot for every token (``_capacity(t) >= t``), so no token is
    dropped."""
    e = model.cfg.moe
    cfg = dataclasses.replace(model.cfg, moe=dataclasses.replace(
        e, capacity_factor=e.n_experts / e.top_k))
    return build(cfg, device="cpu")


@pytest.mark.parametrize("weights,block", FORMATS)
def test_olmoe_engine_matches_jax_engine_and_generate(weights, block):
    """Reduced olmoe through both engines (3 concurrent requests, chunked
    prefill): identical tokens and run statistics, drops included. Then
    the port's engine against the port's ``generate``, as
    ``tests/test_serve_engine.py:132`` holds the reference's. That holds
    only where no token is dropped: which tokens overflow depends on which
    tokens share a forward (generate's prefill of a 13-token prompt has 8
    slots per expert, the engine's ticks of 16 tokens 16). So that check
    runs with capacity_factor E / top_k, where none is."""
    jm = jax_build("olmoe-1b-7b", reduced=True)
    tm = build("olmoe-1b-7b", reduced=True, device="cpu")
    jp = jax_reduced_params(jm, weights, block, seed=4)
    tp = to_port(jp)
    prompts = _prompts([4, 9, 13], jm.cfg.vocab)
    kw = dict(max_batch=2, prefill_chunk=8, page_size=4, max_seq_len=13 + GEN)
    je = jengine.ServeEngine(jm, jp, jengine.EngineConfig(attn_backend="ref",
                                                          **kw))
    te = ServeEngine(tm, tp, EngineConfig(attn_backend="ref", **kw))
    out_j = je.run([japi.Request(prompt=p, max_new_tokens=GEN)
                    for p in prompts])
    out_t = te.run([api.Request(prompt=p, max_new_tokens=GEN)
                    for p in prompts])
    for rid, want in out_j["results"].items():
        np.testing.assert_array_equal(np.asarray(out_t["results"][rid]),
                                      np.asarray(want), err_msg=f"rid {rid}")
    for key in ("n_ticks", "n_prefill_chunks", "n_generated", "n_prompt"):
        assert out_t["stats"][key] == out_j["stats"][key], key

    wide = _no_drop(tm)
    out = ServeEngine(wide, tp, EngineConfig(attn_backend="ref", **kw)).run(
        [api.Request(prompt=p, max_new_tokens=GEN) for p in prompts])
    for rid, p in enumerate(prompts):
        want = generate(wide, tp, torch.tensor(p)[None], GEN)[0]
        np.testing.assert_array_equal(np.asarray(out["results"][rid]),
                                      want.numpy())


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax(arch):
    """Greedy ``generate`` of a batch of 3 from BlockCSR experts."""
    from repro.serve.step import generate as jgenerate
    jm = jax_build(arch, reduced=True)
    tm = build(arch, reduced=True, device="cpu")
    jp = jax_reduced_params(jm, "bcsr", (8, 64), seed=5)
    tp = to_port(jp)
    prompt = np.random.default_rng(10).integers(0, jm.cfg.vocab, (3, 6)) \
        .astype(np.int32)
    want = np.asarray(jgenerate(jm, jp, jnp.asarray(prompt), 6))
    got = generate(tm, tp, torch.tensor(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("weights,block", [("bcsr", (8, 64)), ("pal8", (8, 64))])
def test_restore_jax_moe_checkpoint_generates_same_tokens(tmp_path, weights,
                                                          block):
    """A compressed olmoe checkpoint written by the JAX Checkpointer (E-stacked
    expert stores under (L, E), a dense router and residue) is restored by
    the port's and generates the same greedy tokens."""
    from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
    from repro.serve.step import generate as jgenerate
    from repro_torch.checkpoint.checkpointer import Checkpointer
    from repro_torch.sparse.compress import iter_bcsr
    jm = jax_build("olmoe-1b-7b", reduced=True)
    cp = jax_reduced_params(jm, weights, block, seed=6)
    JaxCheckpointer(str(tmp_path)).save(3, cp, extra={"arch": "olmoe-1b-7b"})
    tp = Checkpointer(str(tmp_path)).restore_compressed(device="cpu")
    experts = {n: m for n, m in iter_bcsr(tp) if "/moe/" in n}
    assert sorted(experts) == [f"layers/b0_attn/moe/{k}"
                               for k in ("ewg", "ewi", "ewo")]
    lead = (jm.cfg.n_super_blocks, jm.cfg.moe.n_experts)
    for m in experts.values():
        assert tuple(m.gather_nnz.shape[:2]) == lead
    assert tuple(tp.dense["layers"]["b0_attn"]["moe"]["router"].shape) == (
        jm.cfg.n_super_blocks, jm.cfg.d_model, jm.cfg.moe.n_experts)
    prompt = np.random.default_rng(11).integers(0, jm.cfg.vocab, (2, 5)) \
        .astype(np.int32)
    want = np.asarray(jgenerate(jm, cp, jnp.asarray(prompt), 6))
    got = generate(build("olmoe-1b-7b", reduced=True, device="cpu"), tp,
                   torch.tensor(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)


def test_densify_round_trips_expert_stacks():
    """``densify_compressed`` scatters (L, E) expert stacks back into the
    stored (L, E, in, out) layout: compressing pruned params and densifying
    gives them back exactly."""
    from repro_torch.sparse import compress as tc
    tm = build("olmoe-1b-7b", reduced=True, device="cpu")
    plan = tc.CompressionPlan(block=(8, 32), min_sparsity=0.3)
    pruned = tc.prune_blocks_for_plan(tm.init(torch.Generator().manual_seed(2)),
                                      plan, 0.6)
    cp = tc.compress_params(pruned, plan)
    assert "moe" in cp.sparse["layers"]["b0_attn"]
    back = tc.densify_compressed(cp, pruned)
    for k in ("ewi", "ewg", "ewo", "router"):
        assert torch.equal(back["layers"]["b0_attn"]["moe"][k],
                           pruned["layers"]["b0_attn"]["moe"][k]), k
