"""Prox operators, schedules, masks, the prox optimizers and the fused
Prox-ADAM update of the port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both. Elementwise
operators agree to 1e-6; the block group-l1 prox to 1e-5 (its block norms
are summed in another order than XLA's) with an equal zero-block pattern.
Optimizer trajectories over 5 steps on identical gradients agree to 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import masks as jmasks
from repro.core import optimizers as jopt
from repro.core import prox as jprox
from repro.core import schedule as jsched
from repro.kernels.prox_adam import ops as jfused
from repro.sparse import compress as jc
from repro_torch.core import masks, optimizers, prox, schedule
from repro_torch.kernels.prox_adam import ops as fused
from repro_torch.sparse import compress as tc

T = torch.tensor


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t)


def _close(a, b, atol):
    np.testing.assert_allclose(_np(a), _np(b), atol=atol, rtol=0)


def _rand(rng, shape, sparse_blocks=False):
    a = rng.normal(size=shape).astype(np.float32)
    if sparse_blocks:
        a[..., ::3, :] = 0.0
    return a


@pytest.mark.parametrize("op", ["soft", "hard", "elastic", "l1_pen",
                                "group_pen", "none"])
def test_elementwise_prox_matches_jax(op):
    rng = np.random.default_rng(0)
    z = _rand(rng, (37, 53))
    fns = {
        "soft": (lambda f, a: f.soft_threshold(a, 0.3)),
        "hard": (lambda f, a: f.hard_threshold(a, 0.5)),
        "elastic": (lambda f, a: f.prox_elastic_net(a, 0.2, 0.1)),
        "l1_pen": (lambda f, a: f.l1_penalty(a)),
        "group_pen": (lambda f, a: f.group_l1_penalty(a, (8, 16))),
        "none": (lambda f, a: f.get_prox("none")(a, 0.3)),
    }
    fn = fns[op]
    tol = 1e-3 if op.endswith("pen") else 1e-6     # sums of ~2000 terms
    _close(fn(prox, T(z)), fn(jprox, jnp.asarray(z)), tol)


@pytest.mark.parametrize("shape,block", [((64, 128), (8, 16)),
                                         ((37, 53), (8, 16)),
                                         ((7, 5, 3), (4, 4))])
def test_group_l1_matches_jax(shape, block):
    rng = np.random.default_rng(1)
    z = _rand(rng, shape)
    if len(shape) == 2:                 # spread the block norms around tau
        br, bc = block
        grid = rng.uniform(0.02, 0.4, (-(-shape[0] // br), -(-shape[1] // bc)))
        z *= np.kron(grid, np.ones(block))[:shape[0], :shape[1]].astype(
            np.float32)
    tau = 1.0
    want = jprox.prox_group_l1_blocks(jnp.asarray(z), tau, block=block)
    got = prox.get_prox("group_l1", block=block)(T(z), tau)
    _close(got, want, 1e-5)
    np.testing.assert_array_equal(_np(got) == 0, np.asarray(want) == 0)
    assert (np.asarray(want) == 0).any()


def test_tree_prox_and_predicate():
    rng = np.random.default_rng(2)
    tree = {"layers": {"w": _rand(rng, (4, 6)), "scale": _rand(rng, (6,))},
            "bias": _rand(rng, (4, 6))}
    jt = {"layers": {k: jnp.asarray(v) for k, v in tree["layers"].items()},
          "bias": jnp.asarray(tree["bias"])}
    tt = {"layers": {k: T(v) for k, v in tree["layers"].items()},
          "bias": T(tree["bias"])}
    want = jprox.tree_prox(jt, 0.5)
    got = prox.tree_prox(tt, 0.5)
    for k in ("w", "scale"):
        _close(got["layers"][k], want["layers"][k], 1e-6)
    _close(got["bias"], tree["bias"], 0)          # never regularized


@pytest.mark.parametrize("name,args", [
    ("constant", (0.3,)), ("warmup_cosine", (1e-2, 5, 20, 1e-4)),
    ("lambda_ramp", (2.0, 7)), ("step_decay", (1.0, 0.5, 3))])
def test_schedules_match_jax(name, args):
    js, ts = getattr(jsched, name)(*args), getattr(schedule, name)(*args)
    for step in range(0, 25):
        want = np.asarray(js(jnp.asarray(step, jnp.int32)))
        np.testing.assert_allclose(_np(ts(step)), want, rtol=1e-6)
        np.testing.assert_allclose(_np(ts(T(step))), want, rtol=1e-6)


def test_zero_mask_apply_density():
    rng = np.random.default_rng(3)
    w = _rand(rng, (6, 8), sparse_blocks=True)
    s = _rand(rng, (8,))
    s[0] = 0.0
    jt = {"w": jnp.asarray(w), "norm": {"scale": jnp.asarray(s)}}
    tt = {"w": T(w), "norm": {"scale": T(s)}}
    jm, tm = jmasks.zero_mask(jt), masks.zero_mask(tt)
    _close(tm["w"], jm["w"], 0)
    _close(tm["norm"]["scale"], jm["norm"]["scale"], 0)   # ones: unregularized
    _close(masks.apply_mask(tt, tm)["w"], jmasks.apply_mask(jt, jm)["w"], 0)
    np.testing.assert_allclose(float(masks.mask_density(tm)),
                               float(jmasks.mask_density(jm)), rtol=1e-6)


# ---------------------------------------------------------------------------
# Optimizers: 5 steps on identical gradients
# ---------------------------------------------------------------------------

L, D, H, HD, FF, V = 2, 32, 4, 8, 64, 50
_PLAN = dict(block=(8, 16), min_sparsity=0.3, min_size=64)


def _params(rng):
    """A model-shaped tree: stacked attention and MLP, an embedding, a
    stacked norm scale and a remainder layer."""
    return {"layers": {"b0_attn": {
                "attn": {"wq": _rand(rng, (L, D, H, HD)),
                         "wo": _rand(rng, (L, H, HD, D))},
                "mlp": {"wi": _rand(rng, (L, D, FF)) * 0.2},
                "pre_norm": {"scale": _rand(rng, (L, D))}}},
            "rem": {"r0_attn": {"mlp": {"wo": _rand(rng, (FF, D)) * 0.2}}},
            "embed": {"embedding": _rand(rng, (V, D))}}


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _pairs(a, b, path=""):
    if isinstance(a, dict):
        for k in a:
            yield from _pairs(a[k], b[k], f"{path}/{k}")
    else:
        yield path, a, b


def _opt_pair(rule, prox_kind, lam):
    make = {"adam": "prox_adam", "rmsprop": "prox_rmsprop", "sgd": "prox_sgd"}[rule]
    kw = {}
    if rule == "sgd":
        kw["momentum"] = 0.9
    jkw, tkw = dict(kw), dict(kw)
    if prox_kind == "group_l1":
        jkw.update(prox_name="group_l1", prox_kwargs={"block": (8, 16)})
        tkw.update(prox_name="group_l1", prox_kwargs={"block": (8, 16)})
    elif prox_kind == "plan":
        jkw["prox_fn"] = jc.make_plan_prox(jc.CompressionPlan(**_PLAN))
        tkw["prox_fn"] = tc.make_plan_prox(tc.CompressionPlan(**_PLAN))
    return (getattr(jopt, make)(3e-2, lam=lam, **jkw),
            getattr(optimizers, make)(3e-2, lam=lam, **tkw))


@pytest.mark.parametrize("rule", ["adam", "rmsprop", "sgd"])
@pytest.mark.parametrize("prox_kind,lam", [("l1", 0.5), ("group_l1", 2.0),
                                           ("plan", 40.0), ("mask", 0.0)])
def test_optimizer_matches_jax(rule, prox_kind, lam):
    rng = np.random.default_rng(4)
    p0 = _params(rng)
    jo, to = _opt_pair(rule, prox_kind, lam)
    jp = _map(jnp.asarray, p0)
    tp = _map(lambda a: T(a.copy()), p0)
    jmask = tmask = None
    if prox_kind == "mask":
        zeroed = _map(lambda a: np.where(rng.random(a.shape) < 0.5, 0, a)
                      .astype(np.float32), p0)
        jp = _map(jnp.asarray, zeroed)
        tp = _map(lambda a: T(a.copy()), zeroed)
        jmask, tmask = jmasks.zero_mask(jp), masks.zero_mask(tp)
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(5):
        g = _map(lambda a: rng.normal(size=a.shape).astype(np.float32), p0)
        jp, js = jo.update(_map(jnp.asarray, g), js, jp, mask=jmask)
        with torch.no_grad():
            tp, ts = to.update(_map(T, g), ts, tp, mask=tmask)
    assert ts.step == int(js.step) == 5
    for tree in ("p", "m", "v"):
        a, b = {"p": (tp, jp), "m": (ts.m, js.m), "v": (ts.v, js.v)}[tree]
        for path, x, y in _pairs(a, b):
            np.testing.assert_allclose(_np(x), np.asarray(y), atol=1e-5,
                                       rtol=0, err_msg=f"{tree}{path}")
    for path, x, y in _pairs(tp, jp):
        np.testing.assert_array_equal(_np(x) == 0, np.asarray(y) == 0,
                                      err_msg=path)
    if prox_kind == "plan":
        # ineligible leaves are untouched by the prox: no exact zeros
        assert (_np(tp["embed"]["embedding"]) != 0).all()
        assert (_np(tp["layers"]["b0_attn"]["pre_norm"]["scale"]) != 0).all()
    if prox_kind in ("group_l1", "plan") and rule != "sgd":
        assert any((_np(x) == 0).any() for _, x, _ in _pairs(tp, jp))


# ---------------------------------------------------------------------------
# Fused Prox-ADAM update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 128), (333, 77), (5,), (3, 5, 7)])
@pytest.mark.parametrize("rule", ["adam", "rmsprop"])
@pytest.mark.parametrize("apply_prox", [True, False])
def test_fused_plain_matches_pallas(shape, rule, apply_prox):
    """The plain version against ``fused_prox_update`` in interpret mode."""
    rng = np.random.default_rng(abs(hash((shape, rule))) % 2**31)
    w = rng.normal(size=shape).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    m = (rng.normal(size=shape) * 0.1).astype(np.float32)
    v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
    jsc = jfused.make_scalars(1e-2, 3.0, 0.9, 0.999, 1e-8, t=7)
    tsc = fused.make_scalars(1e-2, 3.0, 0.9, 0.999, 1e-8, t=7)
    np.testing.assert_array_equal(_np(tsc), np.asarray(jsc))
    want = jfused.fused_update_leaf(jnp.asarray(w), jnp.asarray(g),
                                    jnp.asarray(m), jnp.asarray(v), jsc,
                                    rule=rule, apply_prox=apply_prox,
                                    interpret=True)
    tw, tm, tv = T(w.copy()), T(m.copy()), T(v.copy())
    got = fused.fused_update_leaf(tw, T(g), tm, tv, tsc, rule=rule,
                                  apply_prox=apply_prox)
    assert got[0] is tw and got[1] is tm and got[2] is tv    # in place
    for a, b in zip(got, want):
        _close(a, b, 1e-6)


@pytest.mark.parametrize("rule", ["adam", "rmsprop"])
def test_fused_matches_optimizer_trajectory(rule):
    """Five fused steps equal five steps of the JAX jnp optimizer."""
    rng = np.random.default_rng(5)
    w0 = rng.normal(size=(40, 24)).astype(np.float32)
    lr, lam, b1, b2, eps = 1e-2, 0.5, 0.9, 0.999, 1e-8
    jo = (jopt.prox_adam(lr, lam=lam, b1=b1, b2=b2, eps=eps) if rule == "adam"
          else jopt.prox_rmsprop(lr, lam=lam, beta=b2, eps=eps))
    jp = {"w": jnp.asarray(w0)}
    js = jo.init(jp)
    tw = T(w0.copy())
    tm, tv = torch.zeros_like(tw), torch.zeros_like(tw)
    for t in range(1, 6):
        g = rng.normal(size=w0.shape).astype(np.float32)
        jp, js = jo.update({"w": jnp.asarray(g)}, js, jp)
        sc = fused.make_scalars(lr, lam, b1 if rule == "adam" else 0.0, b2,
                                eps, t)
        fused.fused_update_leaf(tw, T(g), tm, tv, sc, rule=rule)
    _close(tw, jp["w"], 1e-5)
    _close(tv, js.v["w"], 1e-6)


def test_fused_tree_update_respects_predicate():
    rng = np.random.default_rng(6)
    tree = {"w": _rand(rng, (16, 8)), "ln_scale": _rand(rng, (16, 8))}
    tp = {k: T(v.copy()) for k, v in tree.items()}
    g = {k: T(rng.normal(size=v.shape).astype(np.float32))
         for k, v in tree.items()}
    m = {k: torch.zeros_like(v) for k, v in tp.items()}
    v = {k: torch.zeros_like(x) for k, x in tp.items()}
    sc = fused.make_scalars(1e-1, 5.0, 0.9, 0.999, 1e-8, 1)
    jw, jm, jv = jfused.fused_tree_update(
        {k: jnp.asarray(a) for k, a in tree.items()},
        {k: jnp.asarray(_np(a)) for k, a in g.items()},
        {k: jnp.zeros(a.shape) for k, a in tree.items()},
        {k: jnp.zeros(a.shape) for k, a in tree.items()},
        jfused.make_scalars(1e-1, 5.0, 0.9, 0.999, 1e-8, 1), interpret=True)
    fused.fused_tree_update(tp, g, m, v, sc)
    for k in tree:
        _close(tp[k], jw[k], 1e-6)
    assert (_np(tp["w"]) == 0).any()               # prox applied
    assert (_np(tp["ln_scale"]) != 0).all()        # predicate: no prox
