"""Training the MoE family in the port against the JAX package, on the CPU
(reduced olmoe-1b-7b: 4 experts, top-2; reduced llama4-scout-17b-a16e: 4
experts, top-1, a shared expert; f32 compute), with the JAX weights
carried across as numpy.

SpC steps run the plan-aligned group-l1 prox on the (L, E) expert stacks
(each expert's (out, in) view tiled as ``compress_params`` tiles it), and
debias steps train the compressed experts through ``sparse_matmul``'s
expert backward. The loss carries the router's aux losses (1e-2 load
balance and the z-loss), as the reference's.

A random init gives every block of a matrix nearly the same norm, so the
group-l1 zeroes all of a matrix's blocks or none, and the reference's CLI
at its default flags compresses nothing on reduced olmoe. The runs here
therefore start from weights whose blocks were pruned at random
(``prune_blocks_for_plan``), so that the expert stacks do compress, and
the tests assert that they did.

Tolerances, as ``test_torch_train.py``'s: losses and grad_norm within
1e-5 relative (the two packages sum the same f32 products in another
order; a top-k choice at a near tie would part them by a whole expert,
and none occurs on these inputs); params within 2e-5 absolute (Adam's
m / sqrt(v) turns a gradient difference near g = 0 into a step of up to
lr); zero-block patterns equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.core import masks as jmasks
from repro.core import optimizers as jopt
from repro.data import synthetic as jdata
from repro.launch import train as jax_train
from repro.models.model_zoo import build as jax_build
from repro.serve.step import generate as jgenerate
from repro.sparse import compress as jc
from repro.train import loop as jloop
from repro.train import step as jstep
from repro.train.state import TrainState as JState
from repro_torch.core import masks, optimizers
from repro_torch.data import synthetic as tdata
from repro_torch.launch import train
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build
from repro_torch.serve.step import generate
from repro_torch.sparse import compress as tc
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep
from repro_torch.train.state import TrainState
from test_torch_train import _flat_np, _jflat_np
from torch_parity import to_port

ARCHS = ["olmoe-1b-7b", "llama4-scout-17b-a16e"]
BLOCK = (8, 16)
LR = 1e-3
RTOL = 1e-5
LATER_RTOL = 1e-4
P_TOL = 2e-5
G_FLOOR = 1e-4
STORE_RTOL = 1e-4
# The group-l1 threshold lr * LAM must exceed the norm lr sqrt(br bc) that
# one Adam step gives a zeroed (8, 16) block (about 11 lr), or the pruned
# blocks grow back and nothing compresses.
LAM = 20.0


def _plans(block=BLOCK):
    kw = dict(block=block, min_sparsity=0.3)
    return jc.CompressionPlan(**kw), tc.CompressionPlan(**kw)


def _data(jm, seq=16, batch=4):
    return (jdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=seq,
                                    global_batch=batch),
            tdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=seq,
                                    global_batch=batch))


def _pruned(jm, seed, sparsity=0.6, block=BLOCK):
    """JAX params with a random share of the plan's blocks zeroed."""
    jplan, _ = _plans(block)
    return jc.prune_blocks_for_plan(jm.init(jax.random.PRNGKey(seed)), jplan,
                                    sparsity)


def _metrics_close(tm, jmet, first: bool):
    """Step 1 of a phase starts both packages from the same params: its
    metrics agree within RTOL. Later steps start from params that Adam
    parted where its step is ill-conditioned (see ``_assert_params``):
    within LATER_RTOL."""
    for k in ("loss", "grad_norm", "load_balance"):
        np.testing.assert_allclose(float(tm[k]), float(jmet[k]),
                                   rtol=RTOL if first else LATER_RTOL,
                                   err_msg=k)


def _recording(opt, sink: dict):
    """``opt`` whose update keeps, per leaf, the elementwise least |g| of
    the steps so far in ``sink``."""
    inner = opt.update

    def update(grads, state, params, mask=None):
        for k, g in _flat_np(grads).items():
            sink[k] = np.minimum(sink[k], np.abs(g)) if k in sink else np.abs(g)
        return inner(grads, state, params, mask=mask)
    return dataclasses.replace(opt, update=update)


def _assert_params(ts, js, steps: int, g_min: dict):
    """Params within P_TOL wherever Adam's step is well conditioned: every
    step's |g| at least G_FLOOR. Where |g| was smaller, the step lr m_hat /
    (sqrt(v_hat) + eps) moves by about lr |dg| / |g| for a gradient
    difference dg, and dg is not zero: with a top-1 router (llama4-scout)
    the renormalized gate is g / g = 1, whose gradient each package's
    autograd leaves as a rounding residue (about 2^-24 |dL/dgate| a
    token) that reaches every gradient below the MoE layer; those params
    are held within lr a step. Zero patterns equal."""
    a, b = _flat_np(ts.params), _jflat_np(js.params)
    assert a.keys() == b.keys() == g_min.keys()
    for k in a:
        good = g_min[k] >= G_FLOOR
        err = np.abs(a[k] - b[k])
        assert float(err[good].max(initial=0)) <= P_TOL, k
        assert float(err.max(initial=0)) <= LR * steps, k
        np.testing.assert_array_equal(a[k] == 0, b[k] == 0, err_msg=k)


def test_dispatch_counts_positions_in_int32_as_the_reference():
    """The dispatch's position of each (token, choice) pair within its
    expert, on a skewed routing that overflows the capacity: equal to the
    reference's int32 count (``repro/models/moe.py``'s one-hot cumsum, as
    written there), counted in int32; the rows it gives follow, with the
    overflow row past the capacity."""
    rng = np.random.default_rng(21)
    n_e, t, k, cap = 8, 40, 2, 9
    flat = rng.choice(n_e, size=t * k, p=[0.4, 0.2, 0.1, 0.1, 0.1, 0.05,
                                          0.05, 0.0]).astype(np.int32)
    eoh = jax.nn.one_hot(jnp.asarray(flat), n_e, dtype=jnp.int32)
    want = np.asarray(jnp.sum(jnp.cumsum(eoh, axis=0) * eoh, axis=-1) - 1)
    got, _ = tmoe._positions(torch.tensor(flat, dtype=torch.int64), n_e)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    keep = want < cap
    assert (~keep).any() and keep.any()
    rows, _ = tmoe._dispatch(torch.tensor(flat, dtype=torch.int64).reshape(t, k),
                          n_e, cap)
    np.testing.assert_array_equal(
        rows.numpy(), np.where(keep, flat * cap + want, n_e * cap))


def _expert_paths(cp, iter_fn):
    return sorted(p for p, _ in iter_fn(cp) if "/moe/" in p)


@pytest.mark.parametrize("name,shape", [("ewi", (2, 4, 64, 96)),
                                        ("ewg", (2, 4, 64, 96)),
                                        ("ewo", (2, 4, 96, 64))])
def test_plan_prox_on_expert_stacks_matches_jax(name, shape):
    """``make_plan_prox`` on an (L, E, in, out) expert stack: the layer and
    expert axes are a batch, each expert's (out, in) view tiled as the
    plan tiles it; blocks with norms spread over [0.01, 10] around the
    threshold, some zeroed and some shrunk, as the reference's prox does
    them. Within 1e-5: the reference's own prox misses its 1e-6 test by
    f32 rounding (ROADMAP Queue 3)."""
    rng = np.random.default_rng(16)
    br, bc = BLOCK
    z = rng.normal(size=shape).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.01), np.log(10.0),
                               size=shape[:2] + (shape[2] // bc,
                                                 shape[3] // br)))
    z *= np.kron(scale, np.ones((bc, br))).astype(np.float32)
    path = f"['layers']['b0_attn']['moe']['{name}']"
    jplan, tplan = _plans()
    want = np.asarray(jc.make_plan_prox(jplan)(jnp.asarray(z), 1.5, path=path))
    got = tc.make_plan_prox(tplan)(torch.tensor(z), 1.5, path=path).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    blocks = np.abs(want).reshape(shape[:2] + (shape[2] // bc, bc,
                                               shape[3] // br, br))
    zeroed = blocks.max(axis=(3, 5)) == 0
    assert zeroed.any() and not zeroed.all()
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("arch", ARCHS)
def test_spc_then_debias_steps_match_jax(arch):
    """3 SpC steps with ``make_plan_prox`` on every projection, the (L, E)
    expert stacks included; then compression of the result and 3
    mask-frozen debias steps on the compressed experts through
    ``split_trainable`` / ``rebuild``: losses, load balance, grad_norm, the
    params after each phase and their zero-block patterns."""
    jm, tm = jax_build(arch, reduced=True), build(arch, reduced=True,
                                                  device="cpu")
    jp = _pruned(jm, seed=3)
    tp = to_port(jp)
    jplan, tplan = _plans()
    jo = jopt.prox_adam(LR, lam=LAM, prox_fn=jc.make_plan_prox(jplan))
    g_min: dict = {}
    to = _recording(optimizers.prox_adam(LR, lam=LAM,
                                         prox_fn=tc.make_plan_prox(tplan)),
                    g_min)
    jfn = jax.jit(jstep.make_train_step(jm, jo))
    tfn = tstep.make_train_step(tm, to)
    js, ts = JState.create(jp, jo), TrainState.create(tp, to)
    jcfg, tcfg = _data(jm)
    for step in range(3):
        js, jmet = jfn(js, jdata.token_batch(jcfg, step))
        ts, tmet = tfn(ts, tdata.token_batch(tcfg, step))
        _metrics_close(tmet, jmet, step == 0)
    _assert_params(ts, js, 3, g_min)
    # the prox moved the expert stacks: some surviving blocks shrank
    moe = ts.params["layers"]["b0_attn"]["moe"]["ewi"].numpy()
    assert not np.array_equal(moe, np.asarray(jp["layers"]["b0_attn"]["moe"]
                                              ["ewi"]))

    # the same compression of the two results; debias then starts from the
    # JAX package's, so that params Adam parted where its step is ill
    # conditioned (above) do not carry over
    jcp = jc.compress_params(js.params, jplan)
    tcp = tc.compress_params(ts.params, tplan)
    assert _expert_paths(tcp, tc.iter_bcsr) == _expert_paths(jcp, jc.iter_bcsr)
    assert len(_expert_paths(tcp, tc.iter_bcsr)) == 3
    for path, m in jc.iter_bcsr(jcp):
        tm_ = dict(tc.iter_bcsr(tcp))[path]
        np.testing.assert_array_equal(tm_.gather_t_blk.numpy(),
                                      np.asarray(m.gather_t_blk))
    jtr, jrebuild = jc.split_trainable(jcp)
    ttr, trebuild = tc.split_trainable(to_port(jcp))
    g_min = {}
    jo = jopt.prox_adam(LR, lam=0.0)
    to = _recording(optimizers.prox_adam(LR, lam=0.0), g_min)
    js = JState(params=jtr, opt_state=jo.init(jtr), mask=jmasks.zero_mask(jtr),
                step=jnp.zeros((), jnp.int32))
    ts = TrainState(params=ttr, opt_state=to.init(ttr),
                    mask=masks.zero_mask(ttr), step=0)
    init = {p: d.clone() for p, d in ttr["bcsr_data"].items()}
    jfn = jax.jit(jstep.make_train_step(jm, jo, param_transform=jrebuild))
    tfn = tstep.make_train_step(tm, to, param_transform=trebuild)
    for step in range(3):
        js, jmet = jfn(js, jdata.token_batch(jcfg, step))
        ts, tmet = tfn(ts, tdata.token_batch(tcfg, step))
        _metrics_close(tmet, jmet, step == 0)
    _assert_params(ts, js, 3, g_min)
    for path, data in ts.params["bcsr_data"].items():
        assert (data[..., 0, :, :] == 0).all(), path       # the pad slot
        if "/moe/" in path:                                # the experts trained
            assert not torch.equal(data, init[path]), path


def test_spc_retrain_pipeline_matches_jax():
    """SpC -> compress -> debias on reduced olmoe, end to end: histories,
    the report, the compressed structure (the expert stacks compressed,
    (L, E)-stacked) and the trained block stores."""
    arch = "olmoe-1b-7b"
    jm, tm = jax_build(arch, reduced=True), build(arch, reduced=True,
                                                  device="cpu")
    jp = _pruned(jm, seed=4)
    tp = to_port(jp)
    jplan, tplan = _plans()
    jcfg, tcfg = _data(jm)
    lr = 3e-3

    def jmake(o, param_transform=None):
        return jax.jit(jstep.make_train_step(jm, o,
                                             param_transform=param_transform))

    def tmake(o, param_transform=None):
        return tstep.make_train_step(tm, o, param_transform=param_transform)

    jcp, jh_spc, jh_db, jrep = jloop.run_spc_retrain_pipeline(
        jp, jmake, jopt.prox_adam(lr, lam=LAM, prox_fn=jc.make_plan_prox(jplan)),
        jopt.prox_adam(lr, lam=0.0), lambda s: jdata.token_batch(jcfg, s),
        spc_steps=4, debias_steps=3, plan=jplan, log_every=1)
    tcp, th_spc, th_db, trep = tloop.run_spc_retrain_pipeline(
        tp, tmake, optimizers.prox_adam(lr, lam=LAM,
                                        prox_fn=tc.make_plan_prox(tplan)),
        optimizers.prox_adam(lr, lam=0.0), lambda s: tdata.token_batch(tcfg, s),
        spc_steps=4, debias_steps=3, plan=tplan, log_every=1)
    for th, jh in ((th_spc, jh_spc), (th_db, jh_db)):
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        for i, (a, b) in enumerate(zip(th, jh)):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(a[k], b[k], err_msg=k,
                                           rtol=LATER_RTOL if i else RTOL)
    assert trep.keys() == jrep.keys()
    assert trep["spc"]["nnz"] == jrep["spc"]["nnz"]
    assert trep["bcsr_bytes"] == jrep["bcsr_bytes"] < trep["dense_bytes"]
    assert trep["dense_bytes"] == jrep["dense_bytes"]
    jl, tl = dict(jc.iter_bcsr(jcp)), dict(tc.iter_bcsr(tcp))
    assert jl.keys() == tl.keys()
    experts = [p for p in tl if "/moe/" in p]
    assert len(experts) == 3, "the expert stacks did not compress"
    for path in experts:
        assert tuple(tl[path].gather_nnz.shape[:2]) == (
            jm.cfg.n_super_blocks, jm.cfg.moe.n_experts)
    for path in jl:
        assert tl[path].n_blocks == jl[path].n_blocks
        for f in ("gather_idx", "gather_blk", "gather_t_idx", "col_idx",
                  "row_ptr"):
            np.testing.assert_array_equal(getattr(tl[path], f).numpy(),
                                          np.asarray(getattr(jl[path], f)))
        # Adam parts single params where a step's |g| is near zero (see
        # _assert_params), by at most lr a step; the stores as a whole
        # agree within STORE_RTOL of their norm
        got, want = tl[path].data.numpy(), np.asarray(jl[path].data)
        assert float(np.abs(got - want).max()) <= lr * 7, path
        assert np.linalg.norm(got - want) <= STORE_RTOL * np.linalg.norm(
            want), path


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_spc_cli_trains_moe(arch, capsys):
    """``launch/train`` no longer refuses MoE: the dense SpC pipeline
    (elementwise l1, then debias) runs and reports its compression."""
    state, hs, hd, rep = train.main(
        ["--arch", arch, "--reduced", "--steps", "3", "--debias-steps", "2",
         "--batch", "2", "--seq", "16", "--compress", "l1:1.0",
         "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "layer-wise compression:" in out and "debias" in rep
    assert all(np.isfinite(h["loss"]) and h["load_balance"] > 0
               for h in hs + hd)


FLAGS = ["--arch", "olmoe-1b-7b", "--reduced", "--sparse", "--steps", "4",
         "--debias-steps", "2", "--batch", "2", "--seq", "16", "--lr", "3e-3",
         "--compress", f"group_l1:{LAM}", "--block", *map(str, BLOCK),
         "--log-every", "1"]


def _plant(ckpt_dir, jm, lam):
    """A step-1 TrainState of block-pruned weights, written by the JAX
    Checkpointer, which both packages' loops resume from."""
    jplan, _ = _plans()
    params = _pruned(jm, seed=5)
    opt = jopt.prox_adam(3e-3, lam=lam, prox_fn=jc.make_plan_prox(jplan))
    state = JState(params=params, opt_state=opt.init(params), mask=None,
                   step=jnp.ones((), jnp.int32))
    JaxCheckpointer(str(ckpt_dir)).save(1, state)


def test_sparse_cli_resumed_from_planted_checkpoint_matches_jax(tmp_path,
                                                                capsys):
    """``launch/train --sparse`` on reduced olmoe from a planted checkpoint:
    the port's report equals the JAX CLI's, the expert stacks compressed,
    and the JAX package reads the port's compressed MoE checkpoint and
    generates the same greedy tokens as the port from it."""
    jm = jax_build("olmoe-1b-7b", reduced=True)
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    _plant(tdir, jm, LAM)
    _plant(jdir, jm, LAM)
    cp, hs, hd, rep = train.main(FLAGS + ["--device", "cpu", "--ckpt-dir",
                                          str(tdir)])
    capsys.readouterr()
    _, jhs, jhd, jrep = jax_train.main(FLAGS + ["--ckpt-dir", str(jdir)])
    capsys.readouterr()
    assert rep["spc"] == jrep["spc"]
    assert rep["bcsr_bytes"] == jrep["bcsr_bytes"] < rep["dense_bytes"]
    assert rep["dense_bytes"] == jrep["dense_bytes"]
    assert [h["step"] for h in hs] == [h["step"] for h in jhs] == [1, 2, 3]
    for a, b in zip(hs + hd, jhs + jhd):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LATER_RTOL)
    assert len(_expert_paths(cp, tc.iter_bcsr)) == 3

    jcp = JaxCheckpointer(str(tdir / "compressed")).restore_compressed()
    assert _expert_paths(jcp, jc.iter_bcsr) == _expert_paths(cp, tc.iter_bcsr)
    prompt = np.random.default_rng(15).integers(0, jm.cfg.vocab, (2, 5)) \
        .astype(np.int32)
    want = np.asarray(jgenerate(jm, jcp, jnp.asarray(prompt), 6))
    got = generate(build("olmoe-1b-7b", reduced=True, device="cpu"), cp,
                   torch.tensor(prompt), 6)
    np.testing.assert_array_equal(got.numpy(), want)
