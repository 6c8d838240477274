"""The port's paged attention against the JAX package on the CPU.

* The plain version of the paged flash-decode kernel
  (``ref.paged_flash_fwd_ref``: per-split partials ``(acc, m, l)``) and the
  wrapper (``ops.paged_flash_attention``: partials plus the cross-split
  combine, which on the CPU runs that plain version) against the Pallas
  kernel ``paged_flash_fwd`` in interpret mode, on the scenarios of
  ``tests/test_paged_attention_kernel.py``: GQA groups 1 and 4, window
  None and 8, inactive all-trash slots, and the kv_splits 1/2/4/8 identity.
  Tolerance 1e-4 on valid rows (the JAX kernel tests' own), every row
  finite.
* ``models.attention.paged_attention`` and ``Model.paged_step`` against
  the JAX ones: logits within 1e-4 for reduced smollm-360m (dense, BCSR,
  palette-8) and reduced command-r-plus-104b (int8 KV pages), and the
  pools after each step equal to JAX's (the trash page 0 aside: invalid
  tokens all land there, and which of them wins is not specified).
* ``serve.paged_kv.copy_page`` and ``zero_state_slots`` (in place in the
  port) against the JAX ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import ops as jops
from repro.kernels.paged_attention import ref as jref
from repro.kernels.paged_attention.paged_attention import paged_flash_fwd
from repro.models import attention as jattention
from repro.models.model_zoo import build as jax_build
from repro.serve import paged_kv as jpaged
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.models import attention
from repro_torch.models.model_zoo import build
from repro_torch.serve import paged_kv
from torch_parity import jax_numpy, jax_reduced_params, to_port

TOL = 1e-4


def _scenario(rng, *, b=3, c=8, kv=2, g=3, hd=16, ps=4, p_log=6,
              starts=(0, 5, 13), n_tok=(8, 1, 5)):
    """A mixed tick (prefill chunk, decode, partial chunk) over pools that
    hold garbage everywhere, the trash page included, as numpy arrays."""
    h = kv * g
    n_pages = 1 + b * p_log
    q = rng.normal(size=(b, c, h, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, kv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, kv, hd)).astype(np.float32)
    table = (1 + np.arange(b * p_log, dtype=np.int32)).reshape(b, p_log)
    starts = np.asarray(starts, np.int32)
    positions = (starts[:, None] + np.arange(c)[None]).astype(np.int32)
    valid = np.arange(c)[None, :] < np.asarray(n_tok)[:, None]
    return q, kp, vp, table, positions, valid


def _grouped(q, kv):
    b, c, h, hd = q.shape
    return q.reshape(b, c, kv, h // kv, hd).transpose(0, 2, 1, 3, 4).copy()


def _check_partials(q, kp, vp, table, positions, valid, window, splits):
    """Partials of the plain version == the Pallas kernel's, and the
    wrapper == the JAX wrapper, on valid rows."""
    kv = kp.shape[2]
    qg = _grouped(q, kv)
    start = positions[:, 0]
    want = paged_flash_fwd(jnp.asarray(qg), jnp.asarray(kp), jnp.asarray(vp),
                           jnp.asarray(table), jnp.asarray(positions),
                           jnp.asarray(start), window=window,
                           kv_splits=splits, interpret=True)
    got = ref.paged_flash_fwd_ref(torch.tensor(qg), torch.tensor(kp),
                                  torch.tensor(vp), torch.tensor(table),
                                  torch.tensor(positions),
                                  torch.tensor(start), window=window,
                                  kv_splits=splits)
    # (B, KV, S, C, g[, hd]) -> valid rows are (b, c)
    row_valid = valid[:, None, None, :, None]
    for name, w, t in zip(("acc", "m", "l"), want, got):
        w, t = jax_numpy(w), t.numpy()
        assert t.shape == w.shape and np.isfinite(t).all(), name
        mask = row_valid if t.ndim == 5 else row_valid[..., None]
        err = np.abs(t - w)[np.broadcast_to(mask, t.shape)].max()
        assert err < TOL * max(1.0, np.abs(w).max()), (name, err)
    out_j = jops.paged_flash_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(positions), window=window, kv_splits=splits,
        interpret=True)
    out_t = ops.paged_flash_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(table), torch.tensor(positions), window=window,
        kv_splits=splits)
    assert out_t.dtype == torch.float32 and torch.isfinite(out_t).all()
    err = np.abs(out_t.numpy() - jax_numpy(out_j))[valid].max()
    assert err < TOL, err
    return out_t.numpy()


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_kernel_matches_pallas_gqa_and_window(g, window):
    rng = np.random.default_rng(0)
    scen = _scenario(rng, g=g)
    out = _check_partials(*scen, window, 1)
    q, kp, vp, table, positions, valid = scen
    want = jref.paged_attention_ref(jnp.asarray(q), jnp.asarray(kp),
                                    jnp.asarray(vp), jnp.asarray(table),
                                    jnp.asarray(positions), window=window)
    got = ref.paged_attention_ref(torch.tensor(q), torch.tensor(kp),
                                  torch.tensor(vp), torch.tensor(table),
                                  torch.tensor(positions), window=window)
    assert np.abs(got.numpy() - jax_numpy(want))[valid].max() < TOL
    assert np.abs(out - got.numpy())[valid].max() < TOL


def test_plain_kernel_inactive_and_trash_slots():
    """An inactive slot whose page-table row is all zeros (every lookup
    hits the trash page): valid rows match, nothing goes non-finite."""
    rng = np.random.default_rng(1)
    q, kp, vp, table, positions, valid = _scenario(
        rng, b=4, c=6, starts=(0, 9, 2, 0), n_tok=(6, 1, 3, 0))
    table[3] = 0
    _check_partials(q, kp, vp, table, positions, valid, None, 1)
    _check_partials(q, kp, vp, table, positions, valid, None, 3)


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("splits", [2, 4, 8])
def test_kv_split_combine_identity(window, splits):
    """N split lanes give the unsplit output (to float rounding), lanes
    whose pages are all skipped included, and the partials match the
    Pallas kernel's lane by lane."""
    rng = np.random.default_rng(2)
    scen = _scenario(rng, starts=(0, 3, 20), p_log=8, n_tok=(8, 1, 4))
    one = _check_partials(*scen, window, 1)
    many = _check_partials(*scen, window, splits)
    valid = scen[-1]
    assert np.abs(one - many)[valid].max() < 1e-5


def test_empty_split_emits_the_sentinel():
    rng = np.random.default_rng(3)
    q, kp, vp, table, positions, _ = _scenario(rng, starts=(0, 0, 0),
                                               n_tok=(1, 1, 1), c=1)
    acc, m, l = ref.paged_flash_fwd_ref(
        torch.tensor(_grouped(q, 2)), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(table), torch.tensor(positions),
        torch.tensor(positions[:, 0]), kv_splits=3)
    # position 0 only reaches logical page 0: splits 1 and 2 run no page
    assert (m[:, :, 1:] == -1e30).all() and (l[:, :, 1:] == 0).all()
    assert (acc[:, :, 1:] == 0).all() and (l[:, :, 0] > 0).all()
    with pytest.raises(ValueError, match="kv_splits"):
        ops.paged_flash_attention(torch.tensor(q), torch.tensor(kp),
                                  torch.tensor(vp), torch.tensor(table),
                                  torch.tensor(positions), kv_splits=7)


# -- models/attention and Model.paged_step against JAX -----------------------

ATTN_CASES = [("smollm-360m", None), ("command-r-plus-104b", None),
              ("smollm-360m", 8)]


@pytest.mark.parametrize("arch,window", ATTN_CASES)
@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_paged_attention_matches_jax(arch, window, backend):
    """One layer's paged attention over garbage-filled pools: the output on
    valid rows and the pools after the write equal the JAX package's
    ('cuda' on the CPU runs the plain kernel version; JAX runs 'pallas' in
    interpret mode)."""
    import dataclasses
    jm = jax_build(arch, reduced=True)
    cfg_j = dataclasses.replace(jm.cfg, attn_window=window)
    tm = build(arch, reduced=True, device="cpu")
    cfg_t = dataclasses.replace(tm.cfg, attn_window=window)
    jp = jax_reduced_params(jm, "dense", None, seed=5)
    pj = {k: v[0] for k, v in jp["layers"]["b0_attn"]["attn"].items()}
    pt = to_port(pj)
    rng = np.random.default_rng(6)
    b, c, ps, p_log = 3, 4, 4, 5
    n_pages = 1 + b * p_log
    pools_j = jattention.init_paged_kv(cfg_j, n_pages, ps, jnp.float32)
    pools_np = {}
    for name, leaf in pools_j.items():
        if leaf.dtype == jnp.int8:
            pools_np[name] = rng.integers(-127, 128, size=leaf.shape,
                                          dtype=np.int8)
        elif name.endswith("_scale"):
            pools_np[name] = rng.uniform(0.001, 0.02,
                                         size=leaf.shape).astype(np.float32)
        else:
            pools_np[name] = rng.normal(size=leaf.shape).astype(np.float32)
    table = (1 + np.arange(b * p_log, dtype=np.int32)).reshape(b, p_log)
    table[2] = 0                                   # an inactive slot
    starts = np.asarray([7, 0, 0], np.int32)
    positions = (starts[:, None] + np.arange(c)[None]).astype(np.int32)
    n_tokens = np.asarray([4, 2, 0], np.int32)
    x = (rng.normal(size=(b, c, cfg_j.d_model)) * 0.5).astype(np.float32)

    y_j, pools_j2 = jattention.paged_attention(
        pj, jnp.asarray(x), {k: jnp.asarray(v) for k, v in pools_np.items()},
        jnp.asarray(table), jnp.asarray(positions), jnp.asarray(n_tokens),
        cfg_j, backend="pallas" if backend == "cuda" else "ref", kv_splits=2)
    pools_t = {k: torch.tensor(v) for k, v in pools_np.items()}
    y_t, pools_t2 = attention.paged_attention(
        pt, torch.tensor(x), pools_t, torch.tensor(table),
        torch.tensor(positions), torch.tensor(n_tokens), cfg_t,
        backend=backend, kv_splits=2)
    assert pools_t2 is pools_t                     # written in place
    valid = np.arange(c)[None, :] < n_tokens[:, None]
    assert np.isfinite(y_t.numpy()).all()
    err = np.abs(y_t.numpy() - jax_numpy(y_j))[valid].max()
    assert err < TOL, err
    for name in pools_np:
        np.testing.assert_allclose(pools_t2[name].numpy()[1:],
                                   jax_numpy(pools_j2[name])[1:], atol=TOL,
                                   err_msg=name)


STEP_CASES = [("smollm-360m", "dense", None), ("smollm-360m", "bcsr", (8, 64)),
              ("smollm-360m", "pal8", (8, 64)),
              ("command-r-plus-104b", "dense", None)]


def _step_inputs(vocab, rng, *, c, starts, n_tok):
    tokens = rng.integers(0, vocab, size=(len(starts), c)).astype(np.int32)
    return (tokens, np.asarray(starts, np.int32), np.asarray(n_tok, np.int32))


@pytest.mark.parametrize("arch,weights,block", STEP_CASES)
def test_paged_step_matches_jax(arch, weights, block):
    """Two ticks of ``Model.paged_step`` on the ref backend: a prefill
    tick, then a mixed tick (decode, a continued chunk, an inactive slot).
    Logits within 1e-4 of JAX's at each tick, pools equal after each."""
    jm = jax_build(arch, reduced=True)
    tm = build(arch, reduced=True, device="cpu")
    jp = jax_reduced_params(jm, weights, block, seed=7)
    tp = to_port(jp)
    b, ps, p_log = 3, 4, 5
    n_pages = 1 + b * p_log
    pools_j = jpaged.init_paged_cache(jm, n_pages, ps)
    pools_t = paged_kv.init_paged_cache(tm, n_pages, ps)
    table = (1 + np.arange(b * p_log, dtype=np.int32)).reshape(b, p_log)
    rng = np.random.default_rng(8)
    ticks = [_step_inputs(jm.cfg.vocab, rng, c=8, starts=(0, 0, 0),
                          n_tok=(8, 5, 0)),
             _step_inputs(jm.cfg.vocab, rng, c=8, starts=(8, 5, 0),
                          n_tok=(1, 7, 0))]
    for tokens, start, n_tok in ticks:
        lj, pools_j = jm.paged_step(jp, jnp.asarray(tokens), pools_j,
                                    jnp.asarray(table), jnp.asarray(start),
                                    jnp.asarray(n_tok), backend="ref")
        lt, pools_t = tm.paged_step(tp, torch.tensor(tokens), pools_t,
                                    torch.tensor(table), torch.tensor(start),
                                    torch.tensor(n_tok), backend="ref")
        assert lt.dtype == torch.float32 and lt.shape == (b, jm.cfg.vocab)
        active = n_tok > 0
        np.testing.assert_allclose(lt.numpy()[active],
                                   jax_numpy(lj)[active], atol=TOL)
        leaves_j = jax_numpy_leaves(pools_j)
        leaves_t = torch_leaves(pools_t)
        assert leaves_j.keys() == leaves_t.keys()
        for key, want in leaves_j.items():
            np.testing.assert_allclose(leaves_t[key][:, 1:], want[:, 1:],
                                       atol=TOL, err_msg=key)
    assert paged_kv.paged_cache_bytes(pools_t) == jpaged.paged_cache_bytes(
        pools_j)
    assert paged_kv.slot_resource_bytes(pools_t) == \
        jpaged.slot_resource_bytes(pools_j)


def jax_numpy_leaves(pools) -> dict:
    return {f"{layer}/{name}": jax_numpy(leaf)
            for layer, sub in pools["layers"].items()
            for name, leaf in sub["attn"].items()}


def torch_leaves(pools) -> dict:
    return {f"{layer}/{name}": leaf.numpy()
            for layer, sub in pools["layers"].items()
            for name, leaf in sub["attn"].items()}


def test_copy_page_matches_jax():
    jm = jax_build("command-r-plus-104b", reduced=True)
    tm = build("command-r-plus-104b", reduced=True, device="cpu")
    pools_j = jpaged.init_paged_cache(jm, 6, 4)
    rng = np.random.default_rng(9)
    filled = {}
    for layer, sub in pools_j["layers"].items():
        filled[layer] = {"attn": {
            k: rng.integers(-127, 128, size=v.shape, dtype=np.int8)
            if v.dtype == jnp.int8 else
            rng.normal(size=v.shape).astype(np.float32)
            for k, v in sub["attn"].items()}}
    pools_j = {"layers": {layer: {"attn": {k: jnp.asarray(v)
                                           for k, v in sub["attn"].items()}}
                          for layer, sub in filled.items()}}
    pools_t = {"layers": {layer: {"attn": {k: torch.tensor(v)
                                           for k, v in sub["attn"].items()}}
                          for layer, sub in filled.items()}}
    out_j = jpaged.copy_page(pools_j, 4, 2)
    out_t = paged_kv.copy_page(pools_t, 4, 2)
    assert out_t is pools_t
    for key, want in jax_numpy_leaves(out_j).items():
        np.testing.assert_array_equal(torch_leaves(out_t)[key], want)


def test_zero_state_slots_matches_jax():
    """Slot hygiene on a pool tree holding recurrent state beside pages:
    only the state leaves of the masked slots are zeroed, in place."""
    rng = np.random.default_rng(10)
    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    tree = {"layers": {"b0_rglru": {"rec": {"h": f32(2, 3, 4)}},
                       "b1_attn": {"attn": {"k": f32(2, 5, 4)}}},
            "rem": {"r0_rwkv": {"tm": {"s": f32(3, 2)}, "cm": {"x": f32(3, 2)}}}}

    def conv(t, f):
        return {k: conv(v, f) if isinstance(v, dict) else f(v)
                for k, v in t.items()}

    mask = np.asarray([True, False, True])
    want = jpaged.zero_state_slots(conv(tree, jnp.asarray), jnp.asarray(mask))
    pools = conv(tree, torch.tensor)
    got = paged_kv.zero_state_slots(pools, torch.tensor(mask))
    assert got is pools
    flat_w = {}

    def walk(t, prefix, out, f):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "/", out, f)
            else:
                out[prefix + k] = f(v)
    walk(want, "", flat_w, jax_numpy)
    flat_t = {}
    walk(got, "", flat_t, lambda v: v.numpy())
    assert flat_t.keys() == flat_w.keys()
    for k in flat_w:
        np.testing.assert_array_equal(flat_t[k], flat_w[k], err_msg=k)
    assert (flat_t["layers/b1_attn/attn/k"] == tree["layers"]["b1_attn"][
        "attn"]["k"]).all()
