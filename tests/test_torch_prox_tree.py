"""The tree-level fused Prox-ADAM entry of the port on the CPU: the launch
plan that ``csrc/prox_adam.cu`` takes (leaves a launch, flags, block
prefix), the entry against the JAX package's ``fused_tree_update`` in
interpret mode, and ``ProxOptimizer.update`` on a tree of many small
leaves against the JAX optimizer.

Inputs are made with numpy from a seed and fed to both packages. The
plain version computes in f32 in the kernel's order; XLA divides where the
port multiplies by a reciprocal, so the two agree to 1e-6 (f32 w) and, for
a bf16 w, on the same bf16 value.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import optimizers as jopt
from repro.kernels.prox_adam import ops as jfused
from repro_torch.core import optimizers
from repro_torch.kernels.prox_adam import ops as fused
from repro_torch.kernels.prox_adam import ref

T = torch.tensor


def _np(t):
    return t.detach().float().cpu().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, dtype=np.float32)


def _leaf_set(sizes, dtype=torch.float32):
    """w, g, m, v lists of CPU tensors of the given lengths."""
    ws = [torch.zeros(n, dtype=dtype) for n in sizes]
    return ws, [torch.zeros(n) for n in sizes], \
        [torch.zeros(n) for n in sizes], [torch.zeros(n) for n in sizes]


@pytest.mark.parametrize("k,chunk", [(fused.K, fused.CHUNK), (3, 8)])
def test_launch_plan_groups_leaves_in_order(k, chunk):
    """More than 2k leaves, some empty: ceil(L / k) launches of at most k
    leaves, the non-empty leaves each once and in order; each leaf's
    blocks follow the blocks before it and cover its elements once."""
    rng = np.random.default_rng(0)
    sizes = [int(x) for x in rng.integers(1, 5 * chunk, size=2 * k + 5)]
    for i in (0, 4, len(sizes) - 1):
        sizes[i] = 0
    ws, gs, ms, vs = _leaf_set(sizes)
    prox = [i % 3 == 0 for i in range(len(sizes))]
    plan = fused.launch_plan(ws, gs, ms, vs, prox, k=k, chunk=chunk)
    nonempty = [i for i, n in enumerate(sizes) if n]
    assert len(plan) == math.ceil(len(nonempty) / k)
    assert [i for launch in plan for i in launch.leaves] == nonempty
    for launch in plan:
        assert 1 <= len(launch.rows) <= k
        first = 0
        for i, row in zip(launch.leaves, launch.rows):
            w_ptr, g_ptr, m_ptr, v_ptr, n, flags, start = row
            assert (w_ptr, g_ptr, m_ptr, v_ptr) == tuple(
                t.data_ptr() for t in (ws[i], gs[i], ms[i], vs[i]))
            assert n == sizes[i] and start == first
            assert bool(flags & fused.PROX) == prox[i]
            assert not flags & fused.BF16_W
            # block b of the leaf holds [b chunk, (b + 1) chunk): the last
            # block is the one n ends in
            blocks = math.ceil(n / chunk)
            assert (blocks - 1) * chunk < n <= blocks * chunk
            first += blocks
        assert launch.blocks == first


def test_launch_plan_flags():
    """bf16 w, the prox and the vector path (every pointer 16-byte aligned,
    a bf16 w 8) by leaf."""
    base32 = torch.zeros(1001)
    base16 = torch.zeros(1010, dtype=torch.bfloat16)
    ws = [torch.zeros(1000), base32[1:], torch.zeros(1000, dtype=torch.bfloat16),
          base16[4:1004], base16[1:1001], torch.zeros(1000)]
    gs = [torch.zeros(1000) for _ in ws]
    gs[5] = base32[1:]                       # g off a 16-byte boundary
    ms = [torch.zeros(1000) for _ in ws]
    vs = [torch.zeros(1000) for _ in ws]
    prox = [True, False, True, False, True, False]
    (launch,) = fused.launch_plan(ws, gs, ms, vs, prox)
    flags = [row[5] for row in launch.rows]
    V, P, B = fused.VEC, fused.PROX, fused.BF16_W
    assert flags == [V | P, 0, V | P | B, V | B, P | B, 0]


def _mixed_tree(rng):
    """(name, w, g, m, v) of a tree that mixes f32 and bf16 w, prox and
    no-prox leaves, a 1-element leaf, a leaf off a 16-byte boundary and a
    leaf longer than a thread block's chunk."""
    specs = [("prox/conv", (5, 5, 3, 8), torch.float32),
             ("bias", (8,), torch.float32),
             ("prox/one", (1,), torch.float32),
             ("prox/bf16", (33, 17), torch.bfloat16),
             ("bf16_scale", (40,), torch.bfloat16),
             ("prox/off", (999,), torch.float32),
             ("prox/long", (fused.CHUNK + 37,), torch.float32)]
    out = []
    for name, shape, dt in specs:
        w = rng.normal(size=shape).astype(np.float32)
        if dt == torch.bfloat16:   # values a bf16 holds, for both packages
            w = _np(T(w).to(dt))
        g = rng.normal(size=shape).astype(np.float32)
        m = (rng.normal(size=shape) * 0.1).astype(np.float32)
        v = (np.abs(rng.normal(size=shape)) * 0.01).astype(np.float32)
        out.append((name, w, g, m, v, dt))
    return out


@pytest.mark.parametrize("rule", ["adam", "rmsprop"])
def test_tree_update_matches_pallas(rule):
    """``fused_tree_update`` on the CPU against the JAX package's
    ``fused_tree_update`` (interpret mode), leaf by leaf, with the prox on
    the leaves named ``prox/...``."""
    rng = np.random.default_rng(3)
    tree = _mixed_tree(rng)
    sc = fused.make_scalars(1e-2, 3.0, 0.9, 0.999, 1e-8, 7)
    jsc = jfused.make_scalars(1e-2, 3.0, 0.9, 0.999, 1e-8, t=7)

    def jt(i):                                # i: 1 w, 2 g, 3 m, 4 v
        return {leaf[0]: jnp.asarray(leaf[i]).astype(
            jnp.bfloat16 if i == 1 and leaf[5] == torch.bfloat16
            else jnp.float32) for leaf in tree}
    jw, jm, jv = jfused.fused_tree_update(
        jt(1), jt(2), jt(3), jt(4), jsc, rule=rule,
        predicate=lambda name, _: "prox" in name, interpret=True)
    ws = []
    for name, w, *_, dt in tree:
        if name == "prox/off":                # a view 4 bytes into its base
            base = torch.zeros(w.size + 1)
            base[1:] = T(w)
            ws.append(base[1:])
        else:
            ws.append(T(w).to(dt))
    gs, ms, vs = ([T(leaf[i].copy()) for leaf in tree] for i in (2, 3, 4))
    prox = ["prox" in leaf[0] for leaf in tree]
    want = ref.fused_tree_update_ref(ws, gs, ms, vs, sc, rule=rule, prox=prox)
    out = fused.fused_tree_update(ws, gs, ms, vs, sc, rule=rule, prox=prox)
    assert out[0] is ws and out[1] is ms and out[2] is vs   # in place
    for (name, *_), w, m, v, (w2, m2, v2) in zip(tree, ws, ms, vs, want):
        for a, b in ((w, w2), (m, m2), (v, v2)):    # the tree ref, exactly
            assert torch.equal(a, b), name
        np.testing.assert_allclose(_np(w), _np(jw[name]), atol=1e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(_np(m), _np(jm[name]), atol=1e-6, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(_np(v), _np(jv[name]), atol=1e-6, rtol=0,
                                   err_msg=name)
    assert (_np(ws[0]) == 0).any()            # the prox zeroes
    assert (_np(ws[1]) != 0).all()            # no prox on the bias


def test_tree_update_cpu_edges():
    """Empty leaves are left alone, a list needs its prox flags, an unknown
    rule and a second device are refused, and the one-leaf entry is the
    tree entry on one leaf."""
    rng = np.random.default_rng(5)
    sc = fused.make_scalars(1e-1, 1.0, 0.9, 0.999, 1e-8, 2)
    ws = [T(rng.normal(size=n).astype(np.float32)) for n in (0, 7, 0, 130)]
    gs = [T(rng.normal(size=w.shape).astype(np.float32)) for w in ws]
    ms, vs = [torch.zeros_like(w) for w in ws], [torch.zeros_like(w) for w in ws]
    want = ref.fused_tree_update_ref(ws, gs, ms, vs, sc, prox=[True] * 4)
    fused.fused_tree_update(ws, gs, ms, vs, sc, prox=[True] * 4)
    for w, (w2, _, _) in zip(ws, want):
        assert torch.equal(w, w2)
    with pytest.raises(ValueError):
        fused.fused_tree_update(ws, gs, ms, vs, sc)
    with pytest.raises(ValueError):
        fused.fused_tree_update(ws, gs, ms, vs, sc, rule="sgd", prox=[1] * 4)
    with pytest.raises(ValueError, match="one device"):
        fused.fused_tree_update(ws, gs[:3] + [gs[3].to("meta")], ms, vs, sc,
                                prox=[1] * 4)
    w, g = ws[3].clone(), gs[3]
    m, v = ms[3].clone(), vs[3].clone()
    want = ref.fused_prox_update_ref(w, g, m, v, sc, apply_prox=False)
    got = fused.fused_update_leaf(w, g, m, v, sc, apply_prox=False)
    assert got[0] is w
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _cnn_tree(rng):
    """LeNet-5's leaf structure at a cut width: HWIO filters, (in, out)
    dense weights and 1-D biases (the default predicate skips them)."""
    shapes = {"conv1": (5, 5, 1, 4), "conv2": (5, 5, 4, 6), "fc1": (24, 10),
              "fc2": (10, 3)}
    tree = {}
    for name, shape in shapes.items():
        tree[name] = {"w": rng.normal(size=shape).astype(np.float32) * 0.2,
                      "b": rng.normal(size=shape[-1:]).astype(np.float32)}
    return tree


def _tmap(fn, tree):
    return {k: _tmap(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


@pytest.mark.parametrize("rule", ["adam", "rmsprop"])
@pytest.mark.parametrize("masked", [False, True])
def test_optimizer_tree_matches_jax(rule, masked):
    """Four steps of ``ProxOptimizer.update`` (one tree call a step) on a
    CNN-shaped tree against the JAX optimizer, with and without a debias
    mask."""
    rng = np.random.default_rng(9)
    p0 = _cnn_tree(rng)
    mask = _tmap(lambda a: (np.abs(a) > 0.1).astype(np.float32), p0) \
        if masked else None
    make = {"adam": "prox_adam", "rmsprop": "prox_rmsprop"}[rule]
    jo = getattr(jopt, make)(2e-2, lam=0.5)
    to = getattr(optimizers, make)(2e-2, lam=0.5)
    jp, tp = _tmap(jnp.asarray, p0), _tmap(lambda a: T(a.copy()), p0)
    js, ts = jo.init(jp), to.init(tp)
    jmask = None if mask is None else _tmap(jnp.asarray, mask)
    tmask = None if mask is None else _tmap(T, mask)
    for _ in range(4):
        g = _tmap(lambda a: rng.normal(size=a.shape).astype(np.float32), p0)
        jp, js = jo.update(_tmap(jnp.asarray, g), js, jp, mask=jmask)
        with torch.no_grad():
            tp, ts = to.update(_tmap(T, g), ts, tp, mask=tmask)
    for layer in p0:
        for leaf in p0[layer]:
            np.testing.assert_allclose(_np(tp[layer][leaf]),
                                       np.asarray(jp[layer][leaf]),
                                       atol=1e-5, rtol=0)
            np.testing.assert_allclose(_np(ts.v[layer][leaf]),
                                       np.asarray(js.v[layer][leaf]),
                                       atol=1e-6, rtol=0)
    assert any((_np(tp[layer]["w"]) == 0).any() for layer in p0)
