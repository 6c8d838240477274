"""Training in the port against the JAX package, on reduced smollm-360m
(f32 compute), with the JAX weights carried across as numpy.

Gradients are compared tightly: ``grad_norm`` to 1e-4 relative, losses to
1e-4 relative. Adam can turn a tiny gradient difference into a step of up
to lr where |g| is near 0 (m / sqrt(v) is about +-1 whatever |g|); on
these inputs the params after 3 to 9 steps agree to 7.4e-6 (lr 1e-3 to
3e-3), and are held to 2e-5 absolute. Zero-block patterns must be equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as jmasks
from repro.core import optimizers as jopt
from repro.data import synthetic as jdata
from repro.models.model_zoo import build as jax_build
from repro.sparse import compress as jc
from repro.train import loop as jloop
from repro.train import step as jstep
from repro.train.state import TrainState as JState
from repro_torch.core import masks, optimizers
from repro_torch.core.tree import flatten_with_path
from repro_torch.data import synthetic as tdata
from repro_torch.models.model_zoo import build
from repro_torch.sparse import compress as tc
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep
from repro_torch.train.state import TrainState
from torch_parity import jax_numpy, to_port

ARCH = "smollm-360m"
BLOCK = (8, 16)
LR = 1e-3
P_TOL = 2e-5


@pytest.fixture(scope="module")
def models():
    return jax_build(ARCH, reduced=True), build(ARCH, reduced=True,
                                               device="cpu")


def _data(jm, seq=16, batch=4):
    return (jdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=seq,
                                    global_batch=batch),
            tdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=seq,
                                    global_batch=batch))


def _flat_np(tree):
    out = {}
    for keys, leaf in flatten_with_path(tree):
        out["/".join(keys)] = leaf.detach().numpy()
    return out


def _jflat_np(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(k, "key", k)) for k in path): jax_numpy(v)
            for path, v in flat}


def _assert_trees(t, j, atol=P_TOL):
    a, b = _flat_np(t), _jflat_np(j)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0, err_msg=k)
        np.testing.assert_array_equal(a[k] == 0, b[k] == 0, err_msg=k)


def _metrics_close(tm, jmet):
    np.testing.assert_allclose(float(tm["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jmet["grad_norm"]), rtol=1e-4)


def _plans():
    kw = dict(block=BLOCK, min_sparsity=0.3, min_size=256)
    return jc.CompressionPlan(**kw), tc.CompressionPlan(**kw)


def test_token_batches_equal():
    jcfg = jdata.TokenStreamConfig(vocab=99, seq_len=12, global_batch=6)
    tcfg = tdata.TokenStreamConfig(vocab=99, seq_len=12, global_batch=6)
    for step in (0, 3):
        jb, tb = jdata.token_batch(jcfg, step), tdata.token_batch(tcfg, step)
        for k in ("inputs", "labels"):
            assert tb[k].dtype == torch.int32
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    icfg = dict(image_shape=(8, 8, 3), n_classes=4, batch=5)
    ji = jdata.image_batch(jdata.ImageStreamConfig(**icfg), 2)
    ti = tdata.image_batch(tdata.ImageStreamConfig(**icfg), 2)
    np.testing.assert_array_equal(ti["inputs"].numpy(), np.asarray(ji["inputs"]))
    np.testing.assert_array_equal(ti["labels"].numpy(), np.asarray(ji["labels"]))


@pytest.mark.parametrize("variant", ["plain", "microbatches", "seq_chunk"])
def test_spc_steps_match_jax(models, variant):
    """3 SpC steps with the plan-aligned group-l1 prox: losses, grad_norm
    and params."""
    jm, tm = models
    jp = jm.init(jax.random.PRNGKey(0))
    tp = to_port(jp)
    jplan, tplan = _plans()
    kw = {"plain": {}, "microbatches": {"microbatches": 2},
          "seq_chunk": {"loss_seq_chunk": 8}}[variant]
    jo = jopt.prox_adam(LR, lam=50.0, prox_fn=jc.make_plan_prox(jplan))
    to = optimizers.prox_adam(LR, lam=50.0, prox_fn=tc.make_plan_prox(tplan))
    jfn = jax.jit(jstep.make_train_step(jm, jo, **kw))
    tfn = tstep.make_train_step(tm, to, **kw)
    js, ts = JState.create(jp, jo), TrainState.create(tp, to)
    jcfg, tcfg = _data(jm)
    for step in range(3):
        js, jmet = jfn(js, jdata.token_batch(jcfg, step))
        ts, tmet = tfn(ts, tdata.token_batch(tcfg, step))
        _metrics_close(tmet, jmet)
    assert ts.step == int(js.step) == 3
    _assert_trees(ts.params, js.params)


def _compressed(jm, seed=1, sparsity=0.7):
    jplan, _ = _plans()
    jp = jm.init(jax.random.PRNGKey(seed))
    jcp = jc.compress_params(jc.prune_blocks_for_plan(jp, jplan, sparsity),
                             jplan)
    assert len(list(jc.iter_bcsr(jcp))) == 7
    return jcp, to_port(jcp)


def test_debias_steps_match_jax(models):
    """3 mask-frozen debias steps on the compressed params, through
    ``split_trainable`` / ``rebuild``: losses, grad_norm and the trained
    block stores and residue."""
    jm, tm = models
    jcp, tcp = _compressed(jm)
    jtr, jrebuild = jc.split_trainable(jcp)
    ttr, trebuild = tc.split_trainable(tcp)
    jo, to = jopt.prox_adam(LR, lam=0.0), optimizers.prox_adam(LR, lam=0.0)
    js = JState(params=jtr, opt_state=jo.init(jtr),
                mask=jmasks.zero_mask(jtr), step=jnp.zeros((), jnp.int32))
    ts = TrainState(params=ttr, opt_state=to.init(ttr),
                    mask=masks.zero_mask(ttr), step=0)
    jfn = jax.jit(jstep.make_train_step(jm, jo, param_transform=jrebuild))
    tfn = tstep.make_train_step(tm, to, param_transform=trebuild)
    jcfg, tcfg = _data(jm)
    for step in range(3):
        js, jmet = jfn(js, jdata.token_batch(jcfg, step))
        ts, tmet = tfn(ts, tdata.token_batch(tcfg, step))
        _metrics_close(tmet, jmet)
    _assert_trees(ts.params, js.params)
    # the frozen pattern: pad slots and intra-block zeros stayed zero
    for path, data in ts.params["bcsr_data"].items():
        assert (data[..., 0, :, :] == 0).all(), path
    rebuilt = trebuild(ts.params)
    assert all(m.data is ts.params["bcsr_data"][p]
               for p, m in tc.iter_bcsr(rebuilt))


def test_spc_retrain_pipeline_matches_jax(models):
    """SpC -> compress -> debias end to end: histories, the report, the
    compressed structure and the trained block stores."""
    jm, tm = models
    jp = jm.init(jax.random.PRNGKey(2))
    tp = to_port(jp)
    jplan, tplan = _plans()
    jcfg, tcfg = _data(jm)
    jopt_spc = jopt.prox_adam(3e-3, lam=150.0, prox_fn=jc.make_plan_prox(jplan))
    topt_spc = optimizers.prox_adam(3e-3, lam=150.0,
                                    prox_fn=tc.make_plan_prox(tplan))

    def jmake(o, param_transform=None):
        return jax.jit(jstep.make_train_step(jm, o,
                                             param_transform=param_transform))

    def tmake(o, param_transform=None):
        return tstep.make_train_step(tm, o, param_transform=param_transform)

    jcp, jh_spc, jh_db, jrep = jloop.run_spc_retrain_pipeline(
        jp, jmake, jopt_spc, jopt.prox_adam(3e-3, lam=0.0),
        lambda s: jdata.token_batch(jcfg, s), spc_steps=6, debias_steps=3,
        plan=jplan, log_every=2)
    tcp, th_spc, th_db, trep = tloop.run_spc_retrain_pipeline(
        tp, tmake, topt_spc, optimizers.prox_adam(3e-3, lam=0.0),
        lambda s: tdata.token_batch(tcfg, s), spc_steps=6, debias_steps=3,
        plan=tplan, log_every=2)
    for th, jh in ((th_spc, jh_spc), (th_db, jh_db)):
        assert [h["step"] for h in th] == [h["step"] for h in jh]
        for a, b in zip(th, jh):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4, err_msg=k)
    assert trep.keys() == jrep.keys()
    assert trep["spc"]["nnz"] == jrep["spc"]["nnz"]
    assert trep["bcsr_bytes"] == jrep["bcsr_bytes"]
    assert trep["dense_bytes"] == jrep["dense_bytes"]
    jl, tl = dict(jc.iter_bcsr(jcp)), dict(tc.iter_bcsr(tcp))
    assert jl.keys() == tl.keys() and jl
    for path in jl:
        assert tl[path].n_blocks == jl[path].n_blocks
        for f in ("gather_idx", "gather_blk", "gather_t_idx", "col_idx",
                  "row_ptr"):
            np.testing.assert_array_equal(getattr(tl[path], f).numpy(),
                                          np.asarray(getattr(jl[path], f)))
        np.testing.assert_allclose(tl[path].data.numpy(),
                                   np.asarray(jl[path].data), atol=P_TOL)


def test_densify_compressed_matches_jax(models):
    jm, tm = models
    jcp, tcp = _compressed(jm, seed=3)
    like_j = jm.init(jax.random.PRNGKey(3))
    want = jc.densify_compressed(jcp, like_j)
    got = tc.densify_compressed(tcp, to_port(like_j))
    _assert_trees(got, want, atol=0)


def test_eval_step_matches_jax(models):
    jm, tm = models
    jp = jm.init(jax.random.PRNGKey(4))
    jcfg, tcfg = _data(jm)
    want = jstep.make_eval_step(jm)(jp, jdata.token_batch(jcfg, 0))
    got = tstep.make_eval_step(tm)(to_port(jp), tdata.token_batch(tcfg, 0))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
