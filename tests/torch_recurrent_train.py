"""Helpers shared by the recurrent-family training tests
(``test_torch_rglru_train.py``, ``test_torch_rwkv_train.py``): the same
SpC-Retrain runs of a reduced model (f32) in the port and in the JAX
package, from weights the JAX package made and pruned (``pruned``:
``prune_blocks_for_plan`` at 0.6 on (8, 16) blocks), carried across as
numpy. The tolerances and the ``_recording`` / ``_assert_params`` holds are
the MoE training tests' (``test_torch_moe_train.py``).

``check_bf16_grad_drift`` holds a family's bf16 training gradients to the
reference's; ``test_torch_rwkv_train.py`` and
``test_torch_bf16_grad_drift.py`` (the other families) share it."""
from __future__ import annotations

import dataclasses
import functools
import json
import shutil
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.utils._python_dispatch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.configs import get_config as jax_config
from repro.core import optimizers as jopt
from repro.data import synthetic as jdata
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.models.model_zoo import build as jax_build
from repro.sparse import compress as jc
from repro.train import loop as jloop
from repro.train import step as jstep
from repro.train.state import TrainState as JState
from repro_torch.configs import get_config
from repro_torch.core import masks, optimizers
from repro_torch.core.tree import flatten_with_path, tree_map, unflatten_like
from repro_torch.data import synthetic as tdata
from repro_torch.launch import serve, train
from repro_torch.models.model_zoo import build
from repro_torch.sparse import compress as tc
from repro_torch.sparse import ops as sparse_ops
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep
from repro_torch.train.state import TrainState
from test_torch_moe_train import (BLOCK, LAM, LR, RTOL, STORE_RTOL,
                                  _assert_params, _data, _plans, _recording)
from test_torch_train import _jflat_np
from torch_parity import to_port

GRAD_RTOL = 1e-4          # a leaf's gradient, of its largest |g|
# a leaf's bf16 gradient drift: the reference's plus a quarter of it, and
# at least one bf16 rounding of the leaf's largest |g|
BF16_MARGIN_SHARE, BF16_MARGIN_FLOOR = 0.25, 2.0 ** -8
LATER_RTOL = 1e-4         # grad_norm after a phase's first step
RECURRENT = ("/rec/", "/tm/", "/cm/")


def pruned(jm, seed: int, sparsity: float = 0.6):
    """JAX params (``jm.init`` under ``jax.jit``, which takes a second of
    the seconds the op-by-op init takes) with a random share of the plan's
    blocks zeroed."""
    jplan, _ = _plans()
    return jc.prune_blocks_for_plan(jax.jit(jm.init)(jax.random.PRNGKey(seed)),
                                    jplan, sparsity)


class Family:
    """One reduced recurrent architecture in both packages: the models, the
    JAX package's pruned weights, the jitted JAX SpC step (prox-Adam, lr
    ``LR``, the plan's group-l1 at ``LAM``) and, made on first use, both
    packages' SpC-Retrain pipeline at the training length ``seq``
    (``runs``), built once per test file."""

    def __init__(self, arch: str, seq: int):
        self.arch = arch
        self.seq = seq
        self.jm = jax_build(arch, reduced=True)
        self.tm = build(arch, reduced=True, device="cpu")
        self.jplan, self.tplan = _plans()
        self.jp = pruned(self.jm, seed=3)
        self.jspc_opt = jopt.prox_adam(LR, lam=LAM,
                                       prox_fn=jc.make_plan_prox(self.jplan))
        self.jspc = jax.jit(jstep.make_train_step(self.jm, self.jspc_opt))
        self.jgrad = jax.jit(jax.grad(
            lambda p, b: jstep.make_loss_fn(self.jm)(p, b)[0]))

    def tspc_opt(self, sink: dict):
        return _recording(optimizers.prox_adam(
            LR, lam=LAM, prox_fn=tc.make_plan_prox(self.tplan)), sink)

    @functools.cached_property
    def runs(self) -> dict:
        return _pipelines(self)


def _logged(step, log: list, copy):
    """``step`` that appends (params before, params after, metrics) of each
    call to ``log``, the params through ``copy``."""
    def run(state, batch):
        before = copy(state.params)
        state, met = step(state, batch)
        log.append((before, copy(state.params), met))
        return state, met
    return run


def _clone(params):
    return tree_map(lambda t: t.detach().clone(), params)


def _pipelines(fam: Family) -> dict:
    """``run_spc_retrain_pipeline`` (3 SpC steps, compression, 3 debias
    steps) in both packages from the same weights at ``fam.seq``: each
    package's result (``"jax"``, ``"port"``: compressed params, the two
    histories, the report), every step's params before and after and its
    metrics (``"jspc"``, ``"jdb"``, ``"tspc"``, ``"tdb"``; the port's params
    cloned, since its steps update in place), the port's least |g| per leaf
    over the SpC steps (``"g_min"``) and the JAX package's debias rebuild
    (``"jrebuild"``). The JAX SpC phase runs the fixture's jitted step."""
    jcfg, tcfg = _data(fam.jm, seq=fam.seq)
    run = {"jspc": [], "jdb": [], "tspc": [], "tdb": [], "g_min": {}}

    def jmake(o, param_transform=None):
        if param_transform is None:
            assert o is fam.jspc_opt
            return _logged(fam.jspc, run["jspc"], lambda p: p)
        run["jrebuild"] = param_transform
        return _logged(jax.jit(jstep.make_train_step(
            fam.jm, o, param_transform=param_transform)), run["jdb"],
            lambda p: p)

    def tmake(o, param_transform=None):
        return _logged(tstep.make_train_step(
            fam.tm, o, param_transform=param_transform),
            run["tdb" if param_transform else "tspc"], _clone)

    run["jax"] = jloop.run_spc_retrain_pipeline(
        fam.jp, jmake, fam.jspc_opt, jopt.prox_adam(LR, lam=0.0),
        lambda s: jdata.token_batch(jcfg, s), spc_steps=3, debias_steps=3,
        plan=fam.jplan, log_every=1)
    run["port"] = tloop.run_spc_retrain_pipeline(
        to_port(fam.jp), tmake, fam.tspc_opt(run["g_min"]),
        optimizers.prox_adam(LR, lam=0.0),
        lambda s: tdata.token_batch(tcfg, s), spc_steps=3, debias_steps=3,
        plan=fam.tplan, log_every=1)
    return run


def _held(tparams, jparams, steps: int, g_min: dict):
    """``_assert_params`` on two params trees."""
    _assert_params(SimpleNamespace(params=tparams),
                   SimpleNamespace(params=jparams), steps, g_min)


def port_grads(model, params, batch, param_transform=None) -> dict:
    """{leaf path: gradient} of the port's training loss at ``params``."""
    flat = flatten_with_path(params)
    leaves = [p.detach().clone().requires_grad_(True) for _, p in flat]
    loss, _ = tstep.make_loss_fn(model, param_transform=param_transform)(
        unflatten_like(params, leaves), batch)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return {"/".join(k): (torch.zeros_like(p) if g is None else g).numpy()
            for (k, _), g, p in zip(flat, gs, leaves)}


def check_grads_at_equal_params(fam: Family, seq: int, steps: int = 3):
    """Before each of ``steps`` JAX SpC steps, the JAX params are carried
    across and both packages take the loss's gradient there: every leaf
    within GRAD_RTOL of that leaf's largest |g| (a leaf whose gradient is
    exactly zero in the reference, zero in the port). Returns the worst
    ratio per leaf."""
    jcfg, tcfg = _data(fam.jm, seq=seq)
    js = JState.create(fam.jp, fam.jspc_opt)
    worst: dict = {}
    for step in range(steps):
        jb = jdata.token_batch(jcfg, step)
        want = _jflat_np(fam.jgrad(js.params, jb))
        got = port_grads(fam.tm, to_port(js.params),
                         tdata.token_batch(tcfg, step))
        assert got.keys() == want.keys()
        for k, w in want.items():
            scale = float(np.abs(w).max(initial=0))
            err = float(np.abs(got[k] - w).max(initial=0))
            assert err <= GRAD_RTOL * scale, (step, k, err, scale)
            worst[k] = max(worst.get(k, 0.0), err / scale if scale else 0.0)
        js, _ = fam.jspc(js, jb)
    return worst


def recurrent_paths(cp, iter_fn) -> list:
    return sorted(p for p, _ in iter_fn(cp)
                  if any(s in f"/{p}/" for s in RECURRENT))


def _assert_partly_zeroed(cp):
    """Every compressed recurrent projection has some blocks zeroed and
    some resident (in each stacked slice)."""
    paths = recurrent_paths(cp, tc.iter_bcsr)
    assert paths, "no recurrent projection compressed"
    for path, m in tc.iter_bcsr(cp):
        if path in paths:
            resident = m.gather_nnz.reshape(-1, m.block_grid[0]).sum(-1)
            assert ((resident > 0) & (resident < m.block_grid[0]
                                      * m.block_grid[1])).all(), path


def _metrics(tmet, jmet, first: bool, later_rtol: float):
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               rtol=RTOL, err_msg="loss")
    np.testing.assert_allclose(float(tmet["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=RTOL if first else later_rtol,
                               err_msg="grad_norm")


def grad_norm(model, params, batch, param_transform=None) -> float:
    """The port's grad_norm (as the train step computes it) at ``params``."""
    g = port_grads(model, params, batch, param_transform)
    return float(np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                             for v in g.values())))


def check_spc_then_debias(fam: Family, later_rtol: float = LATER_RTOL):
    """The SpC phase of the pipelines (``Family.runs``: 3 steps with
    ``make_plan_prox``), compression, then 3 debias steps of the port
    through ``split_trainable`` / ``rebuild`` from the JAX package's
    compression (so that params Adam parted where a step's |g| is near
    zero do not carry over), against the JAX pipeline's debias from that
    same compression: losses within RTOL at every step, grad_norm within
    RTOL at each phase's first step and ``later_rtol`` after it, params per
    ``_assert_params``, zero patterns equal, the same compressed
    structure, and the recurrent projections compressed with some blocks
    zeroed and not all."""
    run = fam.runs
    _, tcfg = _data(fam.jm, seq=fam.seq)
    for step, (t, j) in enumerate(zip(run["tspc"], run["jspc"])):
        _metrics(t[2], j[2], step == 0, later_rtol)
    tparams = run["tspc"][-1][1]
    _held(tparams, run["jspc"][-1][1], 3, run["g_min"])

    jcp = run["jrebuild"](run["jdb"][0][0])
    tcp = tc.compress_params(tparams, fam.tplan)
    assert [p for p, _ in tc.iter_bcsr(tcp)] == [p for p, _ in
                                                 jc.iter_bcsr(jcp)]
    assert recurrent_paths(tcp, tc.iter_bcsr) == recurrent_paths(
        jcp, jc.iter_bcsr)
    _assert_partly_zeroed(tcp)
    for (path, m), (_, jm_) in zip(tc.iter_bcsr(tcp), jc.iter_bcsr(jcp)):
        np.testing.assert_array_equal(m.gather_t_blk.numpy(),
                                      np.asarray(jm_.gather_t_blk),
                                      err_msg=path)

    ttr, trebuild = tc.split_trainable(to_port(jcp))
    g_min: dict = {}
    to = _recording(optimizers.prox_adam(LR, lam=0.0), g_min)
    ts = TrainState(params=ttr, opt_state=to.init(ttr),
                    mask=masks.zero_mask(ttr), step=0)
    init = {p: d.clone() for p, d in ttr["bcsr_data"].items()}
    tfn = tstep.make_train_step(fam.tm, to, param_transform=trebuild)
    for step, (_, _, jmet) in enumerate(run["jdb"]):
        ts, tmet = tfn(ts, tdata.token_batch(tcfg, step))
        _metrics(tmet, jmet, step == 0, later_rtol)
    _held(ts.params, run["jdb"][-1][1], 3, g_min)
    for path, data in ts.params["bcsr_data"].items():
        assert (data[..., 0, :, :] == 0).all(), path        # the pad slot
        if any(s in f"/{path}/" for s in RECURRENT):        # they trained
            assert not torch.equal(data, init[path]), path


def spread_blocks(rng, shape, block=BLOCK):
    """A stored (..., in, out) weight whose (bc, br) tiles of the (in, out)
    view have norms spread log-uniformly over about [0.01, 10]."""
    br, bc = block
    z = rng.normal(size=shape).astype(np.float32)
    scale = np.exp(rng.uniform(np.log(0.01), np.log(10.0),
                               size=shape[:-2] + (shape[-2] // bc,
                                                  shape[-1] // br)))
    return z * np.kron(scale, np.ones((bc, br))).astype(np.float32)


def check_plan_prox(path: str, shape, eligible: bool = True):
    """``make_plan_prox`` on one stored leaf against the reference's, within
    1e-5 (the reference's own prox misses its 1e-6 test by f32 rounding,
    ROADMAP Queue 3); an eligible leaf gets some blocks zeroed and not all,
    another is returned as it is."""
    z = spread_blocks(np.random.default_rng(len(path)), shape)
    jplan, tplan = _plans()
    want = np.asarray(jc.make_plan_prox(jplan)(jnp.asarray(z), 1.5,
                                               path=path))
    got = tc.make_plan_prox(tplan)(torch.tensor(z), 1.5, path=path).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)
    if not eligible:
        np.testing.assert_array_equal(got, z)
        return
    br, bc = BLOCK
    blocks = np.abs(want).reshape(shape[:-2] + (shape[-2] // bc, bc,
                                                shape[-1] // br, br))
    zeroed = blocks.max(axis=(-3, -1)) == 0
    assert zeroed.any() and not zeroed.all()


def check_pipeline(fam: Family, later_rtol: float = LATER_RTOL,
                   later_gn_rtol: float = LATER_RTOL,
                   store_rtol: float = STORE_RTOL):
    """``run_spc_retrain_pipeline`` (3 SpC steps, compression, 3 debias
    steps) in both packages from the same weights (``Family.runs``): the
    histories (the first step, from equal params, within RTOL; after it
    losses within ``later_rtol`` and grad_norm within ``later_gn_rtol``,
    since params Adam parted carry over, into debias too: each package's
    debias starts from its own compression), the report, the compressed
    structure (paths and every index table) and the trained stores (within
    lr a step, and ``store_rtol`` of their norm). That the later gap is
    the parted params: at each debias step's JAX params, carried across,
    the port's grad_norm is the JAX step's within RTOL."""
    run = fam.runs
    jcp, jh_spc, jh_db, jrep = run["jax"]
    tcp, th_spc, th_db, trep = run["port"]
    for th, jh in ((th_spc, jh_spc), (th_db, jh_db)):
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        for a, b in zip(th, jh):
            assert a.keys() == b.keys()
            for k in a:
                rtol = RTOL if a is th_spc[0] else (
                    later_gn_rtol if k == "grad_norm" else later_rtol)
                np.testing.assert_allclose(a[k], b[k], rtol=rtol, err_msg=k)
    assert trep.keys() == jrep.keys()
    assert trep["spc"] == jrep["spc"]
    assert trep["bcsr_bytes"] == jrep["bcsr_bytes"] < trep["dense_bytes"]
    assert trep["dense_bytes"] == jrep["dense_bytes"]
    jl, tl = dict(jc.iter_bcsr(jcp)), dict(tc.iter_bcsr(tcp))
    assert jl.keys() == tl.keys()
    _assert_partly_zeroed(tcp)
    for path in jl:
        assert tl[path].n_blocks == jl[path].n_blocks
        for f in ("gather_idx", "gather_blk", "gather_nnz", "gather_t_idx",
                  "gather_t_blk", "gather_t_nnz", "col_idx", "row_ptr"):
            np.testing.assert_array_equal(getattr(tl[path], f).numpy(),
                                          np.asarray(getattr(jl[path], f)),
                                          err_msg=f"{path} {f}")
        got, want = tl[path].data.numpy(), np.asarray(jl[path].data)
        assert float(np.abs(got - want).max()) <= LR * 6, path
        assert np.linalg.norm(got - want) <= store_rtol * np.linalg.norm(
            want), path

    _, tcfg = _data(fam.jm, seq=fam.seq)
    _, trebuild = tc.split_trainable(to_port(run["jrebuild"](run["jdb"][0][0])))
    for step, (jparams, _, jmet) in enumerate(run["jdb"]):
        at_jax = grad_norm(fam.tm, to_port(jparams),
                           tdata.token_batch(tcfg, step), trebuild)
        np.testing.assert_allclose(at_jax, float(jmet["grad_norm"]),
                                   rtol=RTOL, err_msg=f"debias {step + 1}")


def cli_flags(arch: str) -> list:
    return ["--arch", arch, "--reduced", "--sparse", "--steps", "4",
            "--debias-steps", "2", "--batch", "2", "--seq", "64", "--lr",
            "3e-3", "--compress", f"group_l1:{LAM}", "--block",
            *map(str, BLOCK), "--log-every", "1"]


def plant(ckpt_dir, jm, lam: float = LAM):
    """A step-1 TrainState of block-pruned weights, written by the JAX
    Checkpointer, which both packages' loops resume from."""
    jplan, _ = _plans()
    params = pruned(jm, seed=5)
    opt = jopt.prox_adam(3e-3, lam=lam, prox_fn=jc.make_plan_prox(jplan))
    JaxCheckpointer(str(ckpt_dir)).save(1, JState(
        params=params, opt_state=opt.init(params), mask=None,
        step=jnp.ones((), jnp.int32)))


def check_cli(fam: Family, tmp_path, capsys):
    """``launch/train --sparse`` on the reduced family from a planted
    checkpoint against ``repro.launch.train`` with the same flags: equal
    reports, losses within LATER_RTOL, the recurrent projections
    compressed; then the port's compressed checkpoint served by both
    packages' ``launch/serve --sparse --ckpt-dir`` (the engine, on a
    request file with explicit prompts) gives equal greedy tokens."""
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    plant(tdir, fam.jm)
    shutil.copytree(tdir, jdir)
    flags = cli_flags(fam.arch)
    cp, hs, hd, rep = train.main(flags + ["--device", "cpu", "--ckpt-dir",
                                          str(tdir)])
    capsys.readouterr()
    _, jhs, jhd, jrep = jax_train.main(flags + ["--ckpt-dir", str(jdir)])
    capsys.readouterr()
    assert rep["spc"] == jrep["spc"]
    assert rep["bcsr_bytes"] == jrep["bcsr_bytes"] < rep["dense_bytes"]
    assert rep["dense_bytes"] == jrep["dense_bytes"]
    assert [h["step"] for h in hs] == [h["step"] for h in jhs] == [1, 2, 3]
    for a, b in zip(hs + hd, jhs + jhd):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=LATER_RTOL)
    _assert_partly_zeroed(cp)

    rng = np.random.default_rng(15)
    reqs = tmp_path / "requests.json"
    reqs.write_text(json.dumps([
        {"prompt": rng.integers(0, fam.jm.cfg.vocab, n).tolist(), "gen": g}
        for n, g in ((5, 4), (11, 3), (3, 5))]))
    args = ["--arch", fam.arch, "--reduced", "--sparse", "--ckpt-dir",
            str(tdir), "--engine", "--requests", str(reqs)]
    got = serve.main(args + ["--device", "cpu"])["results"]
    want = jax_serve.main(args)["results"]
    capsys.readouterr()
    assert len(got) == len(want) == 3
    for rid in want:
        np.testing.assert_array_equal(np.asarray(got[rid]),
                                      np.asarray(want[rid]), err_msg=rid)


def check_dense_cli(arch: str, capsys):
    """The dense SpC pipeline (elementwise l1, then debias) trains the
    recurrent family through ``launch/train`` and reports its compression."""
    state, hs, hd, rep = train.main(
        ["--arch", arch, "--reduced", "--steps", "3", "--debias-steps", "2",
         "--batch", "2", "--seq", "16", "--compress", "l1:1.0",
         "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "layer-wise compression:" in out and "debias" in rep
    assert len(hs) == 3 and len(hd) == 2
    assert all(np.isfinite(h["loss"]) for h in hs + hd)


class ShapeRecorder(torch.utils._python_dispatch.TorchDispatchMode):
    """Every tensor shape an op makes while the mode is on."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def check_no_dense_weight_grad(cfg, monkeypatch, seq: int = 40,
                               batch: int = 2):
    """One debias step of a model of ``cfg`` (the family's reduced config
    with widths that no activation or dense leaf shares): the grads of the
    compressed recurrent projections are their block stores', and no op of
    any dw product (``sparse_ops._dw_product``, the SDDMM's plain version
    here) makes a tensor of a compressed projection's dense (out, in), (in,
    out) or padded (out, in) shape: the torch-side restatement of the
    reference's jaxpr property (``test_spc_retrain.py``). The forward and
    dx of the plain path densify W itself, as the reference's 'ref'
    backend does; the kernel path does not (``chip_smoke.py``)."""
    model = build(cfg, device="cpu")
    plan = tc.CompressionPlan(block=BLOCK, min_sparsity=0.3)
    params = tc.prune_blocks_for_plan(
        model.init(torch.Generator().manual_seed(0)), plan, 0.6)
    cp = tc.compress_params(params, plan)
    rec = recurrent_paths(cp, tc.iter_bcsr)
    assert rec, "no recurrent projection compressed"
    dense_shapes = set()
    for _, m in tc.iter_bcsr(cp):
        (n, k), (br, bc) = m.shape, m.block
        dense_shapes |= {(n, k), (k, n),
                         (m.block_grid[0] * br, m.block_grid[1] * bc)}
    trainable, rebuild = tc.split_trainable(cp)
    seen, calls = {}, []
    opt = optimizers.prox_adam(LR, lam=0.0)

    def record(grads, state, params, mask=None):
        seen.update({"/".join(k): tuple(g.shape)
                     for k, g in flatten_with_path(grads)})
        return opt.update(grads, state, params, mask=mask)

    dw_product = sparse_ops._dw_product
    shapes = ShapeRecorder()

    def recorded(x, dy, w, backend, rows=None):
        calls.append(w.shape)
        with shapes:
            return dw_product(x, dy, w, backend, rows)

    monkeypatch.setattr(sparse_ops, "_dw_product", recorded)
    step = tstep.make_train_step(model, dataclasses.replace(opt,
                                                            update=record),
                                 param_transform=rebuild)
    state = TrainState(params=trainable, opt_state=opt.init(trainable),
                       mask=masks.zero_mask(trainable), step=0)
    step(state, tdata.token_batch(tdata.TokenStreamConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch), 0))
    assert len(calls) == sum(m.data.shape[0] if m.data.dim() == 4 else 1
                             for _, m in tc.iter_bcsr(cp))
    for path in rec:
        assert seen[f"bcsr_data/{path}"] == tuple(
            trainable["bcsr_data"][path].shape)
    assert shapes.shapes and not shapes.shapes & dense_shapes, \
        shapes.shapes & dense_shapes


def _bf16_models(arch, adjust, dtype):
    jc_ = adjust(dataclasses.replace(jax_config(arch).reduced(),
                                     compute_dtype=dtype))
    tc_ = adjust(dataclasses.replace(get_config(arch).reduced(),
                                     compute_dtype=dtype))
    return jax_build(jc_), build(tc_, device="cpu")


def _bf16_grads(jm, tm, jp, seq):
    """(loss, {leaf: gradient}) of the training loss in bf16 in each
    package, at the JAX params ``jp``: the f32 masters of rank >= 2 cast
    to bf16, as both train steps cast them."""
    jcfg, tcfg = _data(jm, seq=seq)

    def jloss(p, b):
        cast = jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                            if x.ndim >= 2 else x, p)
        return jstep.make_loss_fn(jm)(cast, b)[0]

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp, jdata.token_batch(jcfg, 0))
    tp = to_port(jp)
    flat = flatten_with_path(tp)
    leaves = [t.detach().clone().requires_grad_(True) for _, t in flat]
    cast = tree_map(lambda t: t.to(torch.bfloat16) if t.dim() >= 2 else t,
                    unflatten_like(tp, leaves))
    tl, _ = tstep.make_loss_fn(tm)(cast, tdata.token_batch(tcfg, 0))
    tg = torch.autograd.grad(tl, leaves, allow_unused=True)
    return ((float(tl.detach()),
             {"/".join(k): (torch.zeros_like(t) if g is None else g)
              .float().numpy() for (k, _), g, t in zip(flat, tg, leaves)}),
            (float(jl), {k: v.astype(np.float32)
                         for k, v in _jflat_np(jg).items()}))


def check_bf16_grad_drift(arch: str, jp, seq: int = 64,
                          adjust=lambda cfg: cfg, norm: str = "max") -> dict:
    """One bf16 loss-and-gradient of reduced ``arch`` (its config through
    ``adjust`` in both packages) at the JAX params ``jp``, in each
    package. The loss agrees with the JAX package's within 2^-8 relative
    (one bf16 rounding). Two packages that round at different places do
    not give the same bf16 gradients, so each package's bf16 gradient is
    compared with its own f32 gradient at the same params: for every
    leaf, the port's drift is held to the reference's plus max(a quarter
    of it, 2^-8) (``test_torch_bf16_drift.py``'s rule for logits). The
    drift is the largest |bf16 - f32| over the largest f32 |g| (``norm=
    "max"``) or the l2 norm of bf16 - f32 over that of f32 (``"l2"``). A
    bf16-only fault in the port, such as a product rounded to bf16 where
    XLA, compiling the reference, keeps it in f32, shows as a larger
    drift; run with ``XLA_FLAGS=--xla_allow_excess_precision=false`` to
    see the reference's drift with every bf16 round trip of its code
    kept. Printed (``-s``): each leaf's two drifts by both measures.
    Returns {leaf: (port, reference)} by ``norm``."""
    jm16, tm16 = _bf16_models(arch, adjust, "bfloat16")
    jm32, tm32 = _bf16_models(arch, adjust, "float32")
    (tl, tg), (jl, jg) = _bf16_grads(jm16, tm16, jp, seq)
    print(f"{arch} bf16 loss: port {tl:.7g}, JAX {jl:.7g} ({tl / jl - 1:+.2e})")
    assert abs(tl - jl) <= 2 ** -8 * abs(jl)
    jcfg, tcfg = _data(jm32, seq=seq)
    want = _jflat_np(jax.jit(jax.grad(
        lambda p, b: jstep.make_loss_fn(jm32)(p, b)[0]))(
            jp, jdata.token_batch(jcfg, 0)))
    got = port_grads(tm32, to_port(jp), tdata.token_batch(tcfg, 0))
    assert tg.keys() == jg.keys() == want.keys() == got.keys()

    def drift(bf16, f32, kind):
        if kind == "max":
            return float(np.abs(bf16 - f32).max() / (np.abs(f32).max() or 1.0))
        return float(np.linalg.norm(bf16 - f32) / (np.linalg.norm(f32) or 1.0))

    def above(a, b):
        return a > b + max(BF16_MARGIN_SHARE * b, BF16_MARGIN_FLOOR)

    drifts, over = {}, []
    for k in sorted(want, key=lambda k: -np.abs(want[k]).max()):
        both = {kind: (drift(tg[k], got[k], kind), drift(jg[k], want[k], kind))
                for kind in ("max", "l2")}
        drifts[k] = both[norm]
        # which package is above the other's rule, by each measure
        flags = [f"{who} above by {kind}" for kind, (p, r) in both.items()
                 for who, a, b in (("port", p, r), ("JAX", r, p))
                 if above(a, b)]
        print(f"{k}: bf16 gradient drift from f32, port / JAX: largest "
              "|error| / largest |g| {:.2e} / {:.2e}, l2 {:.2e} / {:.2e}  {}"
              .format(*both["max"], *both["l2"], "; ".join(flags)))
        if above(*drifts[k]):
            over.append((k, *drifts[k]))
    assert not over, over
    return drifts
