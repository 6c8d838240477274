"""The port under a (2, 2) rank mesh on the CPU: 4 gloo ranks, spawned
once for the file (``torch_mesh_ranks.run``), against the port's single
process and the JAX package.

  * serving smollm-360m (reduced, f32) from BlockCSR and palette-4 weights
    carried over from the JAX package: prefill logits within 1e-5 of one
    process (equality is expected where a kernel runs unchanged on a
    shard; the plain path's BLAS may block a narrower product
    differently) and within 1e-4 of the JAX package's single-device
    prefill, the reference's gate; ``generate``'s and the engine's greedy
    tokens equal one process's; the same through the CLIs;
  * training qwen3-0.6b (reduced), the reference's own mesh case: 8
    prox-Adam steps; ``launch/train --sparse`` with a block that the FSDP
    split of ``embed`` cuts in two, and with one it does not;
  * the expert-parallel MoE against the single-program path, with and
    without dropped tokens;
  * the compressed all-reduce, a checkpoint saved on (2, 2) restored on
    (4, 1) and on one process, and the data pipeline's rows per rank.
"""
from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ranks as R
from repro.core import optimizers as jopt
from repro.data import synthetic as jdata
from repro.distributed import collectives as jcoll
from repro.models import moe as jmoe
from repro.models.model_zoo import build as jax_build
from repro.sparse import compress as jc
from repro.sparse.compress import CompressedParams as JaxCompressedParams
from repro.sparse.formats import BlockCSR as JaxBlockCSR
from repro.sparse.formats import PaletteBCSR as JaxPaletteBCSR
from repro.train import state as jstate
from repro.train import step as jstep
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import optimizers
from repro_torch.core import prox as prox_lib
from repro_torch.core.tree import flatten_with_path
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import serve, train
from repro_torch.models.model_zoo import build
from repro_torch.sparse.compress import iter_bcsr, quantize_compressed
from repro_torch.sparse.formats import is_bcsr
from repro_torch.train.state import TrainState
from torch_parity import to_port

# the 4 ranks' whole run takes about 15 s on 6 cores; they are stopped
# and the tests fail past this
RANKS_TIMEOUT = 300
SERVE_CLI = ["--reduced", "--sparse", "--batch", "2", "--prompt-len", "4",
             "--gen", "3", "--device", "cpu"]
TRAIN_CLI = ["--arch", "smollm-360m", "--reduced", "--sparse", "--steps",
             "5", "--debias-steps", "2", "--batch", "2", "--seq", "16",
             "--lr", "3e-3", "--compress", "group_l1:20", "--device", "cpu",
             "--log-every", "1"]
# (8, 64) blocks span the reduced model's whole d = 64, which FSDP splits
# 32 | 32 over "data": every block of an (in = d) matrix is cut in two
TRAIN_CASES = {"cut_block": (8, 64), "whole_block": (8, 16)}


def _train_argv(tmp, tag, mesh):
    return TRAIN_CLI + ["--block", *map(str, TRAIN_CASES[tag]), "--mesh",
                        mesh, "--ckpt-dir", str(tmp / f"train_{tag}_{mesh}")]


def _plant(ckpt_dir, block):
    """A step-1 TrainState whose blocks (``block`` on the (out, in) grid
    of every projection) have norms spread log-uniformly over [0.01, 1],
    as trained weights' are: a random init gives every block nearly one
    norm, so group-l1 zeroes all of a matrix's blocks or none."""
    model = build("smollm-360m", reduced=True, device="cpu")
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen)
    br, bc = block
    with torch.no_grad():
        for sub, names in (("attn", ("wq", "wk", "wv", "wo")),
                           ("mlp", ("wi", "wg", "wo"))):
            for name in names:
                t = params["layers"]["b0_attn"][sub][name]
                flat = (t.flatten(-2) if name in ("wq", "wk", "wv")
                        else t.flatten(1, -2))
                norms = prox_lib._block_reduce_l2(flat, (bc, br))
                target = torch.exp(math.log(0.01) + torch.rand(
                    norms.shape, generator=gen) * math.log(100.0))
                scale = (target / norms.clamp_min(1e-30)).repeat_interleave(
                    bc, -2).repeat_interleave(br, -1)
                flat.mul_(scale[..., :flat.shape[-2], :flat.shape[-1]])
    opt = optimizers.prox_adam(3e-3, lam=20.0)
    Checkpointer(str(ckpt_dir)).save(1, TrainState(
        params=params, opt_state=opt.init(params), mask=None, step=1))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Everything one process and the JAX package computed, and what the
    4 ranks computed (one spawn)."""
    tmp = tmp_path_factory.mktemp("mesh")
    jm = jax_build(R.SERVE_ARCH, reduced=True)
    prompt = np.random.default_rng(4).integers(
        0, jm.cfg.vocab, size=(4, 8)).astype(np.int32)
    torch.save(torch.tensor(prompt), tmp / "prompt.pt")
    c = {"tmp": tmp, "prompt": prompt, "jax": {}, "one": {}}
    model = build(R.SERVE_ARCH, reduced=True, device="cpu")
    plan = jc.CompressionPlan(block=(8, 16), min_sparsity=0.3)
    dense = jax.jit(jm.init)(jax.random.PRNGKey(3))
    jp = jc.compress_params(jc.prune_blocks_for_plan(dense, plan, 0.6), plan)
    # palette-4 quantized by the port (the JAX k-means takes seconds here)
    # and carried back: both packages run the same codes and palettes
    cps = {"bcsr": to_port(jp)}
    cps["pal4"] = quantize_compressed(cps["bcsr"], bits=4)
    for fmt, cp in cps.items():
        cache = jm.init_cache(4, 8 + R.GEN)
        c["jax"][fmt] = np.asarray(jm.prefill(_to_jax(cp, jp.plan),
                                              jnp.asarray(prompt), cache)[0])
        torch.save(cp, tmp / f"serve_{fmt}.pt")
        c["one"][fmt] = R.serve_outputs(model, cp, torch.tensor(prompt))
    tm, jt = R.TRAIN_ARCH, jax_build(R.TRAIN_ARCH, reduced=True)
    jparams = jt.init(jax.random.PRNGKey(0))
    params = to_port(jparams)
    torch.save(params, tmp / "train_params.pt")
    c["train_params"] = params
    c["one"]["train"] = R.train_run(build(tm, reduced=True, device="cpu"),
                                    to_port(jparams))
    c["jax"]["train"] = _jax_train(jt, jparams)
    spec = {"dir": str(tmp), "prompt": str(tmp / "prompt.pt"),
            "serve_bcsr": str(tmp / "serve_bcsr.pt"),
            "serve_pal4": str(tmp / "serve_pal4.pt"),
            "train_params": str(tmp / "train_params.pt"),
            "ckpt": str(tmp / "ckpt"),
            "serve_cli": SERVE_CLI + ["--mesh", "2,2", "--logits-out",
                                      str(tmp / "cli_mesh.npy")],
            "train_cli": {tag: _train_argv(tmp, tag, "2,2")
                          for tag in TRAIN_CASES}}
    for tag, block in TRAIN_CASES.items():
        for mesh in ("none", "2,2"):
            _plant(tmp / f"train_{tag}_{mesh}", block)
    mesh_lib.run_ranks(R.run, 4, "cpu", (spec,), timeout=RANKS_TIMEOUT,
                       store_dir=tmp)
    c["ranks"] = torch.load(tmp / "ranks.pt", weights_only=False)
    return c


def _to_jax(cp, plan):
    """The port's ``CompressedParams`` as the JAX package's."""
    def leaf(x):
        if is_bcsr(x):
            cls = JaxPaletteBCSR if hasattr(x, "codes") else JaxBlockCSR
            return cls(**{f.name: (jnp.asarray(getattr(x, f.name).numpy())
                                   if isinstance(getattr(x, f.name),
                                                 torch.Tensor)
                                   else getattr(x, f.name))
                          for f in dataclasses.fields(x)})
        if isinstance(x, dict):
            return {k: leaf(v) for k, v in x.items()}
        return jnp.asarray(x.numpy())
    return JaxCompressedParams(dense=leaf(cp.dense), sparse=leaf(cp.sparse),
                               plan=plan)


def _jax_train(jm, params) -> list:
    opt = jopt.prox_adam(R.TRAIN_LR, lam=R.TRAIN_LAM)
    data = jdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=R.TRAIN_SEQ,
                                   global_batch=R.TRAIN_BATCH)
    state = jstate.TrainState.create(params, opt)
    step = jax.jit(jstep.make_train_step(jm, opt))
    losses = []
    for s in range(R.TRAIN_STEPS):
        state, m = step(state, jdata.token_batch(data, s))
        losses.append(float(m["loss"]))
    return losses


def test_the_ranks_ran_gloo_on_four_processes(case):
    assert case["ranks"]["world"] == 4 and case["ranks"]["backend"] == "gloo"


def test_data_rows_follow_the_data_coordinate(case):
    """Ranks 0 and 1 share data coordinate 0 and read the same rows;
    the two coordinates' rows make the global batch."""
    rows = case["ranks"]["batch_rows"]
    assert rows[0] == rows[1] and rows[2] == rows[3] and rows[0] != rows[2]
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    whole = token_batch(TokenStreamConfig(vocab=128, seq_len=8,
                                          global_batch=4), 0)["inputs"]
    assert rows[0] + rows[2] == whole.tolist()


@pytest.mark.parametrize("fmt", ["bcsr", "pal4"])
def test_sharded_prefill_matches_one_process_and_jax(case, fmt):
    got = case["ranks"][f"serve_{fmt}"]["logits"].numpy()
    one = case["one"][fmt]["logits"].numpy()
    np.testing.assert_allclose(got, one, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, case["jax"][fmt], atol=1e-4, rtol=0)
    # the compressed projections were split: q, k, v, wi, wg by block rows
    # over "model", both wo over "data"
    layout = case["ranks"][f"layout_{fmt}"]
    axes = {k[1].rsplit("/", 1)[-1]: v for k, v in layout.items()
            if k[0] == "bcsr"}
    assert axes == {"wq": "model", "wk": "model", "wv": "model",
                    "wi": "model", "wg": "model", "wo": "data"}, axes


@pytest.mark.parametrize("fmt", ["bcsr", "pal4"])
def test_sharded_tokens_match_one_process(case, fmt):
    got, one = case["ranks"][f"serve_{fmt}"], case["one"][fmt]
    assert torch.equal(got["tokens"], one["tokens"])
    assert len(np.unique(one["tokens"].numpy())) >= 3
    assert got["engine"] == one["engine"]


def test_serve_cli_mesh_logits_match_no_mesh(case, tmp_path):
    out = tmp_path / "none.npy"
    serve.main(SERVE_CLI + ["--mesh", "none", "--logits-out", str(out)])
    np.testing.assert_allclose(np.load(case["tmp"] / "cli_mesh.npy"),
                               np.load(out), atol=1e-5, rtol=0)


def test_sharded_training_matches_one_process_and_jax(case):
    got, one = case["ranks"]["train"], case["one"]["train"]
    losses, ref = got["losses"], one[0]
    assert abs(losses[0] - ref[0]) <= 1e-5 * abs(ref[0])
    for a, b in zip(losses[1:], ref[1:]):
        assert abs(a - b) <= 1e-4 * abs(b), (losses, ref)
    np.testing.assert_allclose(got["norms"], one[1], rtol=1e-4)
    for (k, a), (_, b) in zip(flatten_with_path(got["params"]),
                              flatten_with_path(one[2])):
        tol = 1e-3 * max(float(b.abs().max()), 1e-12)
        assert float((a - b).abs().max()) <= tol, k
    jax_losses = case["jax"]["train"]
    assert max(abs(a - b) for a, b in zip(losses, jax_losses)) < 2e-2
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("tag", sorted(TRAIN_CASES))
def test_train_cli_mesh_matches_no_mesh(case, tag):
    """``launch/train --sparse --mesh 2,2``: the block sparsity of one
    process, and block stores within 1% of their norm after debias."""
    cp, hs, hd, _ = train.main(_train_argv(case["tmp"], tag, "none"))
    got = case["ranks"][f"train_cli_{tag}"]
    one = {p: int(m.gather_nnz.sum()) for p, m in iter_bcsr(cp)}
    assert one and got["resident"] == one
    for p, m in iter_bcsr(cp):
        diff = (got["stores"][p] - m.data).norm() / m.data.norm()
        assert float(diff) <= 1e-2, (p, float(diff))
    ref = [h["loss"] for h in hs + hd]
    np.testing.assert_allclose(got["losses"], ref, rtol=1e-4)


def _moe_one(tag):
    cfg = R.moe_config(tag == "moe_nodrop")
    p, x = R.moe_inputs(cfg)
    return cfg, p, x


def test_expert_parallel_moe_matches_the_single_program_path(case):
    """No token dropped: y, the load-balance loss and the gradients of the
    expert-parallel path equal the single-program path's within the
    reference's bounds (``tests/test_distributed_mesh.py``)."""
    got = case["ranks"]["moe_nodrop"]
    assert got["ep"] == 1 and got["experts_here"] == 2
    cfg, p, x = _moe_one("moe_nodrop")
    y, aux, g = R.moe_loss_grads(p, x, cfg, impl="gspmd")
    assert float((got["y"] - y).abs().max()) < 1e-4
    assert abs(got["aux"]["load_balance"] - aux["load_balance"]) < 1e-5
    for k in g:
        rel = (got["grads"][k] - g[k]).abs().max() / g[k].abs().max()
        assert float(rel) < 1e-5, k


def test_expert_parallel_moe_drops_at_each_data_shards_capacity(case):
    """Tokens dropped: the expert-parallel y equals the JAX package's
    single-program MoE run on each data shard's tokens alone, at that
    shard's capacity (the oracle), and differs from the whole batch's
    dispatch."""
    got = case["ranks"]["moe_drop"]
    cfg, p, x = _moe_one("moe_drop")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), p)
    from repro.configs import get_config as jax_config
    base = jax_config(R.MOE_ARCH).reduced()
    jcfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=R.DROP))
    moe = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg, impl="gspmd")[0])
    oracle = np.concatenate([np.asarray(moe(jp, jnp.asarray(xs.numpy())))
                             for xs in x.chunk(2, 0)], 0)
    np.testing.assert_allclose(got["y"].numpy(), oracle, atol=1e-4, rtol=0)
    with torch.no_grad():
        whole = R.moe_lib.apply_moe(p, x, cfg, impl="gspmd")[0].numpy()
    assert np.abs(whole - oracle).max() > 1e-3


def test_compressed_all_reduce_is_the_references_formula(case):
    qs, ss = [], []
    for r in range(4):
        g = np.random.default_rng(r).normal(size=(7, 5)).astype(np.float32)
        q, s = jcoll.quantize_int8(jnp.asarray(g))
        qs.append(np.asarray(q).astype(np.int32))
        ss.append(float(s))
    want = np.sum(qs, 0).astype(np.float32) * np.float32(max(ss)) / 4
    np.testing.assert_allclose(case["ranks"]["all_reduce_compressed"].numpy(),
                               want, rtol=1e-6, atol=1e-7)


def _dense_slices(m) -> list:
    lead = tuple(m.gather_nnz.shape[:-1])
    return [m.map(lambda t, i=i: t[i]).to_dense() for i in np.ndindex(*lead)]


def _same_compressed(a, b):
    for (pa, ma), (pb, mb) in zip(iter_bcsr(a), iter_bcsr(b)):
        assert pa == pb
        for x, y in zip(_dense_slices(ma), _dense_slices(mb)):
            assert torch.equal(x, y), pa
    for (k, x), (_, y) in zip(flatten_with_path(a.dense),
                              flatten_with_path(b.dense)):
        assert torch.equal(x, y), k


def test_checkpoint_saved_on_2x2_restores_on_4x1_and_one_process(case):
    want = torch.load(case["tmp"] / "serve_bcsr.pt", weights_only=False)
    _same_compressed(case["ranks"]["restored_41"], want)
    layout = case["ranks"]["restored_41_layout"]
    assert {v for k, v in layout.items() if k[0] == "bcsr"} == {"model",
                                                               "data"}
    _same_compressed(Checkpointer(str(case["tmp"] / "ckpt"))
                     .restore_compressed(3, device="cpu"), want)
    for (k, a), (_, b) in zip(flatten_with_path(case["ranks"]["dense_41"]),
                              flatten_with_path(case["train_params"])):
        assert torch.equal(a, b), k
