"""The paper's CNN pipeline in the port against the JAX package, on the
CPU: ``train/cnn.spc_with_retrain`` (the counterpart of
``benchmarks/common.py``), the MM baseline (``core/mm``), magnitude
pruning (``core/pruning``), the host data pipeline (``data/pipeline``,
``data/synthetic.token_stream``) and ``launch/paper_cnn`` (the
counterpart of ``examples/paper_cnn_pipeline.py``) at cut constants.

LeNet-5 starts from the JAX package's init at the same seed, carried
across as numpy: the port's model is ``CNN_ZOO["lenet5"]`` with ``init``
replaced by that carry (``_lenet_from_jax``), so both pipelines run their
own code from the same weights and batches.

Tolerances, with their reasons:
- every step of the JAX pipeline is retaken in the port from the JAX
  step's params, moments and batch: its loss within 1e-5 relative, its
  gradients within 1e-4 of each leaf's largest |g|, and the params after
  it within 1e-4 of each leaf's largest |value| wherever |g| is at least
  1e-3 of the leaf's largest |g|: the same f32 arithmetic, convolutions
  summed in another order. Elsewhere within 2 lr: Adam moves an element
  by about lr whatever its |g|, so where |g| is at the level of the two
  packages' rounding its sign, and the step, may differ. LeNet-5 at the
  reference's init (He with fan-in = the filter's height) has logits in
  the hundreds, so the pipelines, each run on its own, part there: after
  6 + 3 steps fc1's weights differ by up to 5% of their largest |value|,
  at about 2 lr. So of the two whole runs only these are held: the first
  step's loss (equal params) within 1e-5 relative, every element within
  2 lr a step plus 1e-4 of its leaf's largest |value|, and
- compression rates within 1e-4 absolute: an element within an ulp of
  the threshold may fall either way (one element of LeNet-5 is 2.3e-6);
- accuracies equal: argmax over 10 classes of nearly equal logits;
- MM: params, theta, lambda and the momentum within 1e-5 of each leaf's
  largest |value| (the same elementwise f32 arithmetic); pruning and the
  data pipeline exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.core import masks as jmasks
from repro.core import metrics as jmetrics
from repro.core import mm as jmm
from repro.core import pruning as jpruning
from repro.core.optimizers import prox_adam as jprox_adam
from repro.data import pipeline as jpipeline
from repro.data import synthetic as jdata
from repro.models import cnn as jcnn
from repro.train.losses import softmax_xent as jxent
from repro_torch.core import mm, pruning
from repro_torch.core.optimizers import ProxState
from repro_torch.core.prox import prox_l1, soft_threshold
from repro_torch.data import pipeline as tpipeline
from repro_torch.data import synthetic as tdata
from repro_torch.launch import paper_cnn
from repro_torch.models import cnn
from repro_torch.train import cnn as tcnn
from test_torch_train import _flat_np, _jflat_np
from torch_parity import to_port

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
PARAM_RTOL = 1e-4
LR = 1e-3                   # spc_with_retrain's default
COMP_ATOL = 1e-4
MM_RTOL = 1e-5
SPC = dict(lam=1.0, steps=6, retrain_steps=3, batch=8)
# MM at cut cadences, so that six steps cross two C-steps and three mu
# growths
MM_CUT = jmm.MMConfig(alpha=1e-2, mu0=0.3, mu_growth=1.2, mu_every=2,
                      c_step_every=3, learning_rate=2e-3)


def _lenet_from_jax():
    """The port's LeNet-5 whose init is the JAX package's at the
    generator's seed, carried across."""
    jm = jcnn.CNN_ZOO["lenet5"]
    return dataclasses.replace(
        cnn.CNN_ZOO["lenet5"],
        init=lambda g, d: to_port(jm.init(jax.random.PRNGKey(
            g.initial_seed())), d))


def _recording(module, monkeypatch, sink: list, steps=None):
    """Make ``module.make_cnn_step``'s steps append their losses to
    ``sink`` and, given ``steps``, (params, opt state, batch, mask, params
    after, loss) to it (the JAX package's steps are functional)."""
    make = module.make_cnn_step

    def recorded(model, opt):
        step = make(model, opt)

        def run(params, opt_state, batch, mask=None):
            out = step(params, opt_state, batch, mask)
            sink.append(float(out[2]))
            if steps is not None:
                steps.append((params, opt_state, batch, mask, out[0],
                              out[2]))
            return out
        return run

    monkeypatch.setattr(module, "make_cnn_step", recorded)


def _assert_params(tp, jp, rtol=PARAM_RTOL, slack=0.0):
    got, want = _flat_np(tp), _jflat_np(jp)
    assert got.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                   atol=rtol * np.abs(w).max() + slack)


def _retake(jsteps, model):
    """Each recorded JAX step (params, moments, batch, mask in; params and
    loss out) retaken by the port's step from the same inputs, carried
    across: the spc steps with lam 1.0, the retrain steps (with a mask)
    with lam 0."""
    for params, state, batch, mask, out_params, loss in jsteps:
        lam = SPC["lam"] if mask is None else 0.0
        opt = tcnn.get_optimizer("prox_adam", learning_rate=LR, lam=lam)
        tp = to_port(params)
        ts = ProxState(step=int(state.step), m=to_port(state.m),
                       v=to_port(state.v))
        tb = {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}
        _, g = tcnn.loss_and_grads(model, tp, tb)
        g = _flat_np(g)
        want_g = _jflat_np(jax.grad(lambda p: jxent(
            jcnn.CNN_ZOO["lenet5"].apply(p, batch["inputs"]),
            batch["labels"]))(params))
        for k, w in want_g.items():
            np.testing.assert_allclose(g[k], w, rtol=0, err_msg=k,
                                       atol=GRAD_RTOL * np.abs(w).max())
        tp, _, tl = tcnn.make_cnn_step(model, opt)(
            tp, ts, tb, None if mask is None else to_port(mask))
        np.testing.assert_allclose(float(tl), float(loss), rtol=LOSS_RTOL)
        got, want = _flat_np(tp), _jflat_np(out_params)
        for k, w in want.items():
            steep = np.abs(want_g[k]) >= 1e-3 * np.abs(want_g[k]).max()
            err = np.abs(got[k] - w)
            assert (err[steep] <= PARAM_RTOL * np.abs(w).max()).all(), k
            assert (err <= 2 * LR + PARAM_RTOL * np.abs(w).max()).all(), k


def test_spc_with_retrain_matches_jax(monkeypatch):
    jl, tl, jsteps = [], [], []
    _recording(jcommon, monkeypatch, jl, jsteps)
    _recording(tcnn, monkeypatch, tl)
    jm = jcnn.CNN_ZOO["lenet5"]
    want = jcommon.spc_with_retrain(jm, **SPC)
    model = _lenet_from_jax()
    got = tcnn.spc_with_retrain(model, **SPC, device="cpu")
    n = SPC["steps"] + SPC["retrain_steps"]
    assert len(tl) == len(jl) == len(jsteps) == n
    np.testing.assert_allclose(tl[0], jl[0], rtol=LOSS_RTOL)
    _retake(jsteps, model)
    for key, steps in (("spc", SPC["steps"]), ("retrain", n)):
        assert 0 < want[f"{key}_compression"] < 1
        assert abs(got[f"{key}_compression"]
                   - want[f"{key}_compression"]) <= COMP_ATOL
        _assert_params(got[f"{key}_params"], want[f"{key}_params"],
                       slack=2 * LR * steps)
    # the retrain phase kept SpC's zeros of the weights (not the biases,
    # which are not regularized) and trained a copy
    for k, w in _flat_np(got["spc_params"]).items():
        if k.endswith("/w"):
            assert (_flat_np(got["retrain_params"])[k][w == 0] == 0).all(), k
    data = tcnn.data_for(cnn.CNN_ZOO["lenet5"])
    assert tcnn.evaluate_cnn(cnn.CNN_ZOO["lenet5"], got["retrain_params"],
                             data) == jcommon.evaluate_cnn(
        jm, want["retrain_params"], jcommon.data_for(jm))


def test_train_cnn_leaves_the_given_params_alone():
    """The port's optimizer updates in place; ``train_cnn`` trains a copy,
    as the reference's functional loop leaves its input as it was."""
    model = cnn.CNN_ZOO["lenet5"]
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    before = _flat_np(params)
    before = {k: v.copy() for k, v in before.items()}
    out, _ = tcnn.train_cnn(model, tcnn.get_optimizer(
        "prox_adam", learning_rate=1e-3, lam=1.0), 2, params=params, batch=4)
    for k, v in _flat_np(params).items():
        np.testing.assert_array_equal(v, before[k])
    assert any((_flat_np(out)[k] != v).any() for k, v in before.items())


def test_train_cnn_history_matches_jax():
    """``eval_every``: the history's losses, accuracies and compression
    rates."""
    jm = jcnn.CNN_ZOO["lenet5"]
    opt_kw = dict(learning_rate=1e-3, lam=1.0)
    _, jh = jcommon.train_cnn(jm, jprox_adam(**opt_kw), 4, batch=8,
                              eval_every=2)
    _, th = tcnn.train_cnn(_lenet_from_jax(), tcnn.get_optimizer(
        "prox_adam", **opt_kw), 4, batch=8, eval_every=2, device="cpu")
    assert [h["step"] for h in th] == [h["step"] for h in jh] == [2, 4]
    for t, j in zip(th, jh):
        # the runs part where Adam steps on rounding-level gradients
        # (see the module docstring): losses within 1e-3 relative
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=1e-3)
        assert t["acc"] == j["acc"]
        assert abs(t["compression"] - j["compression"]) <= COMP_ATOL


def _mm_grads(jp, steps, seed=5):
    rng = np.random.default_rng(seed)
    flat = _jflat_np(jp)
    return [{k: (0.1 * rng.normal(size=v.shape)).astype(np.float32)
             for k, v in flat.items()} for _ in range(steps)]


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        node = out
        *head, last = path.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def test_mm_update_matches_jax():
    """Six MM iterations from LeNet-5's init with gradients from a seed:
    C-steps at steps 3 and 6, mu growths at 2, 4 and 6; the bias leaves
    take plain SGD steps."""
    jp = jax.jit(jcnn.CNN_ZOO["lenet5"].init)(jax.random.PRNGKey(0))
    tp = to_port(jp)
    cfg = mm.MMConfig(**dataclasses.asdict(MM_CUT))
    js, ts = jmm.mm_init(jp, MM_CUT), mm.mm_init(tp, cfg)
    for g in _mm_grads(jp, 6):
        jp, js = jmm.mm_update(_nest({k: jnp.asarray(v)
                                      for k, v in g.items()}), js, jp, MM_CUT)
        with torch.no_grad():
            tp, ts = mm.mm_update(_nest({k: torch.from_numpy(v)
                                         for k, v in g.items()}), ts, tp, cfg)
    assert ts.step == int(js.step) == 6
    assert np.float32(ts.mu) == np.asarray(js.mu)
    for got, want in ((tp, jp), (ts.theta, js.theta), (ts.lam, js.lam),
                      (ts.momentum, js.momentum)):
        _assert_params(got, want, MM_RTOL)
    lam = _flat_np(ts.lam)
    assert (lam["conv1/w"] != 0).any() and (lam["fc1/bias"] == 0).all()
    final = _flat_np(mm.mm_final_params(tp, ts))
    want = _jflat_np(jmm.mm_final_params(jp, js))
    assert (final["fc1/w"] == 0).any()
    for k, w in want.items():
        np.testing.assert_allclose(final[k], w, rtol=0,
                                   atol=MM_RTOL * np.abs(w).max(), err_msg=k)
    assert mm.mm_state_bytes(ts) == jmm.mm_state_bytes(js)


@pytest.mark.parametrize("quality", [0.0, 0.5, 1.5])
def test_magnitude_prune_std_matches_jax(quality):
    jp = jax.jit(jcnn.CNN_ZOO["lenet5"].init)(jax.random.PRNGKey(2))
    got = _flat_np(pruning.magnitude_prune_std(to_port(jp), quality))
    want = _jflat_np(jpruning.magnitude_prune_std(jp, quality))
    for k, w in want.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.953, 1.0])
def test_magnitude_prune_global_matches_jax(sparsity):
    jp = jax.jit(jcnn.CNN_ZOO["lenet5"].init)(jax.random.PRNGKey(2))
    got = pruning.magnitude_prune_global(to_port(jp), sparsity)
    want = jpruning.magnitude_prune_global(jp, sparsity)
    for k, w in _jflat_np(want).items():
        np.testing.assert_array_equal(_flat_np(got)[k], w, err_msg=k)
    assert abs(tcnn.metrics_lib.compression_rate(got)
               - jmetrics.compression_rate(want)) == 0


def test_prox_l1_is_soft_threshold():
    z = torch.linspace(-2, 2, 41)
    assert torch.equal(prox_l1(z, 0.5), soft_threshold(z, 0.5))


def test_sharded_batcher_tiles_the_global_batch_as_jax():
    cfg = tdata.TokenStreamConfig(vocab=100, seq_len=8, global_batch=8)
    jcfg = jdata.TokenStreamConfig(vocab=100, seq_len=8, global_batch=8)
    parts = [tpipeline.ShardedBatcher(cfg, process_index=i,
                                      process_count=4).batch(3)
             for i in range(4)]
    for key in ("inputs", "labels"):
        stacked = np.concatenate([p[key].numpy() for p in parts])
        np.testing.assert_array_equal(
            stacked, np.asarray(jdata.token_batch(jcfg, 3)[key]))
        np.testing.assert_array_equal(
            parts[2][key].numpy(), np.asarray(jpipeline.ShardedBatcher(
                jcfg, process_index=2, process_count=4).batch(3)[key]))
    one = tpipeline.ShardedBatcher(cfg)      # no process group: 0 of 1
    assert (one.process_index, one.process_count) == (0, 1)
    it = one.stream(5)
    for step in (5, 6):
        np.testing.assert_array_equal(
            next(it)["inputs"].numpy(),
            np.asarray(jdata.token_batch(jcfg, step)["inputs"]))
    with pytest.raises(ValueError):
        tpipeline.ShardedBatcher(cfg, process_index=0, process_count=3)


def test_prefetcher_orders_steps():
    cfg = tdata.TokenStreamConfig(vocab=50, seq_len=4, global_batch=2)
    jcfg = jdata.TokenStreamConfig(vocab=50, seq_len=4, global_batch=2)
    pf = tpipeline.Prefetcher(lambda s: tdata.token_batch(cfg, s),
                              start_step=5, depth=2)
    got = [next(pf) for _ in range(4)]
    pf.close()
    assert [s for s, _ in got] == [5, 6, 7, 8]
    for s, b in got:
        assert b["inputs"].device.type == "cpu"
        np.testing.assert_array_equal(
            b["inputs"].numpy(),
            np.asarray(jdata.token_batch(jcfg, s)["inputs"]))


def test_token_stream_matches_jax():
    cfg = tdata.TokenStreamConfig(vocab=64, seq_len=6, global_batch=3, seed=2)
    jcfg = jdata.TokenStreamConfig(vocab=64, seq_len=6, global_batch=3, seed=2)
    ts, js = tdata.token_stream(cfg, 4), jdata.token_stream(jcfg, 4)
    for _ in range(3):
        t, j = next(ts), next(js)
        for key in ("inputs", "labels"):
            np.testing.assert_array_equal(t[key].numpy(), np.asarray(j[key]))


def _jax_example_rows(steps, retrain_steps, lam, cfg):
    """``examples/paper_cnn_pipeline.py``'s flow at cut constants."""
    model = jcnn.CNN_ZOO["lenet5"]
    data_cfg = jcommon.data_for(model)
    ev = lambda p: jcommon.evaluate_cnn(model, p, data_cfg)  # noqa: E731
    ref, _ = jcommon.train_cnn(model, jprox_adam(1e-3, lam=0.0), steps)
    rows = [("reference", ev(ref), 0.0)]
    out = jcommon.spc_with_retrain(model, lam=lam, steps=steps,
                                   retrain_steps=retrain_steps)
    rows += [("SpC", ev(out["spc_params"]), out["spc_compression"]),
             ("SpC(Retrain)", ev(out["retrain_params"]),
              out["retrain_compression"])]
    pruned = jpruning.magnitude_prune_global(ref, out["spc_compression"])
    rows.append(("Pru", ev(pruned), jmetrics.compression_rate(pruned)))
    pr_rt, _ = jcommon.train_cnn(model, jprox_adam(1e-3, lam=0.0),
                                 retrain_steps, params=pruned,
                                 mask=jmasks.zero_mask(pruned))
    rows.append(("Pru(Retrain)", ev(pr_rt), jmetrics.compression_rate(pr_rt)))
    state, p = jmm.mm_init(ref, cfg), ref
    for s in range(steps):
        b = jdata.image_batch(data_cfg, s)
        g = jax.grad(lambda q: jxent(model.apply(q, b["inputs"]),
                                     b["labels"]))(p)
        p, state = jmm.mm_update(g, state, p, cfg)
    final = jmm.mm_final_params(p, state)
    rows.append(("MM", ev(final), jmetrics.compression_rate(final)))
    return rows


def test_paper_cnn_main_matches_the_example(monkeypatch, capsys):
    """``python -m repro_torch.launch.paper_cnn --device cpu`` at cut
    constants (the example's STEPS 250 and retrain 100 cut to 6 and 3, MM
    at the cut cadences) against the example's flow in the JAX package."""
    monkeypatch.setattr(paper_cnn, "CNN_ZOO",
                        dict(cnn.CNN_ZOO, lenet5=_lenet_from_jax()))
    cut = dict(steps=6, retrain_steps=3, lam=1.0)
    got = paper_cnn.main(["--device", "cpu"], **cut,
                         mm_config=mm.MMConfig(**dataclasses.asdict(MM_CUT)))
    printed = capsys.readouterr().out.splitlines()
    want = _jax_example_rows(**cut, cfg=MM_CUT)
    assert printed[0].split() == ["method", "accuracy", "compression"]
    assert [r[0] for r in got] == [r[0] for r in want] == [
        line.split()[0] for line in printed[1:]]
    for (name, acc, comp), (_, jacc, jcomp) in zip(got, want):
        assert acc == jacc, name
        assert abs(comp - jcomp) <= COMP_ATOL, name
    assert got[1][2] > 0 and got[-1][2] > 0
