"""The port's RG-LRU and RWKV-6 modules against ``repro.models.rglru`` and
``repro.models.rwkv6``, function by function, on the same numpy inputs.

f32 throughout. The scans combine the same terms in another order (the
port's doubling scan against ``jax.lax.associative_scan``; torch's and
XLA's einsums), so outputs agree to f32 rounding: 1e-5 absolute plus 1e-5
relative. Masked (inactive) slots must keep their state bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import rglru as jrglru
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config
from repro_torch.models import rglru, rwkv6
from torch_parity import to_port

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(got, want, **kw):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(kw or TOL))


def _wkv_inputs(seed, b=2, s=64, h=2, hd=8, decay_hi=2.0):
    """r, k, v, logw (B, S, H, hd), u (H, hd), state (B, H, hd, hd). The
    log-decays reach -exp(decay_hi) per step, so the cumulative log-decay
    of a 64-step chunk passes the clamp at 25."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = -np.exp(rng.uniform(-6.0, decay_hi, (b, s, h, hd))).astype(np.float32)
    u = rng.normal(size=(h, hd)).astype(np.float32)
    state = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, state


@pytest.mark.parametrize("s", [5, 64, 128])
@pytest.mark.parametrize("carried", [False, True])
def test_chunked_wkv(s, carried):
    """One short chunk, one full chunk (the clamp bites), two chunks."""
    r, k, v, logw, u, state = _wkv_inputs(s, s=s)
    st = state if carried else None
    jo, js = jrwkv.chunked_wkv(*map(jnp.asarray, (r, k, v, logw, u)),
                               None if st is None else jnp.asarray(st))
    to, ts = rwkv6.chunked_wkv(*map(torch.tensor, (r, k, v, logw, u)),
                               None if st is None else torch.tensor(st))
    scale = float(np.abs(np.asarray(jo)).max())
    _close(to, jo, atol=1e-5 * scale, rtol=1e-5)
    _close(ts, js, atol=1e-5 * float(np.abs(np.asarray(js)).max()), rtol=1e-5)


def test_chunked_wkv_keeps_the_chunk_rule():
    r, k, v, logw, u, _ = _wkv_inputs(0, s=80)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        rwkv6.chunked_wkv(*map(torch.tensor, (r, k, v, logw, u)), None)


def test_wkv_step():
    r, k, v, logw, u, state = _wkv_inputs(1, s=1)
    jo, js = jrwkv.wkv_step(*map(jnp.asarray, (r, k, v, logw, u, state)))
    to, ts = rwkv6.wkv_step(*map(torch.tensor, (r, k, v, logw, u, state)))
    _close(to, jo)
    _close(ts, js)


def test_wkv_scan_masked_advance():
    """A tick of C = 6 positions: slot 0 carries 6 valid tokens, slot 1
    three (c < C), slot 2 none (inactive: state kept bit for bit)."""
    r, k, v, logw, u, state = _wkv_inputs(2, b=3, s=6)
    valid = np.arange(6)[None, :] < np.array([6, 3, 0])[:, None]
    jo, js = jrwkv.wkv_scan(*map(jnp.asarray, (r, k, v, logw, u, state, valid)))
    to, ts = rwkv6.wkv_scan(*map(torch.tensor, (r, k, v, logw, u, state, valid)))
    _close(to, jo)
    _close(ts, js)
    np.testing.assert_array_equal(ts[2].numpy(), state[2])


@pytest.mark.parametrize("carried", [False, True])
def test_causal_conv(carried):
    rng = np.random.default_rng(3)
    u = rng.normal(size=(2, 7, 16)).astype(np.float32)
    kern = rng.normal(size=(4, 16)).astype(np.float32)
    st = rng.normal(size=(2, 3, 16)).astype(np.float32) if carried else None
    jy, js = jrglru._causal_conv(jnp.asarray(u), jnp.asarray(kern),
                                 None if st is None else jnp.asarray(st))
    ty, ts = rglru._causal_conv(torch.tensor(u), torch.tensor(kern),
                                None if st is None else torch.tensor(st))
    _close(ty, jy)
    _close(ts, js)


def _rglru_params(seed=0):
    cfg = jax_config("recurrentgemma-9b").reduced()
    p = jrglru.init_rglru(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    # non-zero gates, so r and i depend on u
    for name in ("gate_w_a", "gate_b_a", "gate_w_x", "gate_b_x"):
        p[name] = jnp.asarray(rng.normal(size=p[name].shape) * 0.5, jnp.float32)
    return cfg, p, to_port(p)


@pytest.mark.parametrize("s", [1, 7, 33])
def test_rglru_scan_with_carried_state(s):
    """The doubling scan against the associative scan, S not a power of 2
    included, with h0 folded into the first step."""
    _, jp, tp = _rglru_params()
    rng = np.random.default_rng(s)
    u = rng.normal(size=(2, s, 64)).astype(np.float32)
    h0 = rng.normal(size=(2, 64)).astype(np.float32)
    jh, jl = jrglru.rglru_scan(jp, jnp.asarray(u), jnp.asarray(h0))
    th, tl = rglru.rglru_scan(tp, torch.tensor(u), torch.tensor(h0))
    _close(th, jh)
    _close(tl, jl)


def test_rglru_step():
    _, jp, tp = _rglru_params()
    rng = np.random.default_rng(4)
    u = rng.normal(size=(3, 1, 64)).astype(np.float32)
    h = rng.normal(size=(3, 64)).astype(np.float32)
    jy, jh = jrglru.rglru_step(jp, jnp.asarray(u), jnp.asarray(h))
    ty, th = rglru.rglru_step(tp, torch.tensor(u), torch.tensor(h))
    _close(ty, jy)
    _close(th, jh)


def _tick(seed, d, c=6):
    """x (3, C, d) with n_tokens (C, 2, 0): full, c < C, inactive."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(3, c, d)).astype(np.float32)
    return x, np.array([c, 2, 0], np.int32)


def test_rglru_block_paged():
    jcfg, jp, tp = _rglru_params(1)
    cfg = get_config("recurrentgemma-9b").reduced()
    x, n = _tick(5, jcfg.d_model)
    rng = np.random.default_rng(6)
    state = {"h": rng.normal(size=(3, 64)).astype(np.float32),
             "conv": rng.normal(size=(3, 3, 64)).astype(np.float32)}
    jy, js = jrglru.apply_rglru_block_paged(
        jp, jnp.asarray(x), jcfg, jax.tree.map(jnp.asarray, state),
        jnp.asarray(n))
    ty, ts = rglru.apply_rglru_block_paged(
        tp, torch.tensor(x), cfg, {k: torch.tensor(a) for k, a in state.items()},
        torch.tensor(n))
    valid = np.arange(x.shape[1])[None, :] < n[:, None]
    _close(ty[torch.tensor(valid)], np.asarray(jy)[valid])
    for key in ("h", "conv"):
        _close(ts[key], js[key])
        np.testing.assert_array_equal(ts[key][2].numpy(), state[key][2])


def _rwkv_params(seed=0):
    jcfg = jax_config("rwkv6-3b").reduced()
    key = jax.random.PRNGKey(seed)
    jp = {"tm": jrwkv.init_time_mix(key, jcfg),
          "cm": jrwkv.init_channel_mix(jax.random.fold_in(key, 1), jcfg)}
    rng = np.random.default_rng(seed)
    # a non-zero decay LoRA, so the decay depends on the input
    jp["tm"]["lora_w"]["lora_b"] = jnp.asarray(
        rng.normal(size=jp["tm"]["lora_w"]["lora_b"].shape) * 0.3, jnp.float32)
    return jcfg, get_config("rwkv6-3b").reduced(), jp, to_port(jp)


@pytest.mark.parametrize("carried", [False, True])
def test_time_and_channel_mix(carried):
    """The full-sequence forms (chunked WKV) from a zero state, and one
    decode step from a carried state."""
    jcfg, cfg, jp, tp = _rwkv_params()
    rng = np.random.default_rng(7)
    d, hd = jcfg.d_model, jcfg.rwkv_head_dim
    s = 1 if carried else 9
    x = rng.normal(size=(2, s, d)).astype(np.float32)
    st = None
    if carried:
        st = {"tm": {"S": rng.normal(size=(2, d // hd, hd, hd)).astype(np.float32),
                     "shift": rng.normal(size=(2, d)).astype(np.float32)},
              "cm": {"shift": rng.normal(size=(2, d)).astype(np.float32)}}
    jst = None if st is None else jax.tree.map(jnp.asarray, st)
    tst = None if st is None else jax.tree.map(torch.tensor, st)
    jy, js = jrwkv.apply_time_mix(jp["tm"], jnp.asarray(x), jcfg,
                                  jst and jst["tm"])
    ty, ts = rwkv6.apply_time_mix(tp["tm"], torch.tensor(x), cfg,
                                  tst and tst["tm"])
    _close(ty, jy)
    for key in ("S", "shift"):
        _close(ts[key], js[key])
    jf, jc = jrwkv.apply_channel_mix(jp["cm"], jnp.asarray(x), jst and jst["cm"])
    tf, tc = rwkv6.apply_channel_mix(tp["cm"], torch.tensor(x), tst and tst["cm"])
    _close(tf, jf)
    _close(tc["shift"], jc["shift"])


def test_time_and_channel_mix_paged():
    """The engine's mixed step with a carried state and a tick whose slots
    carry C, c < C and 0 valid tokens."""
    jcfg, cfg, jp, tp = _rwkv_params(2)
    d, hd = jcfg.d_model, jcfg.rwkv_head_dim
    x, n = _tick(8, d)
    rng = np.random.default_rng(9)
    st = {"tm": {"S": rng.normal(size=(3, d // hd, hd, hd)).astype(np.float32),
                 "shift": rng.normal(size=(3, d)).astype(np.float32)},
          "cm": {"shift": rng.normal(size=(3, d)).astype(np.float32)}}
    jst, tst = jax.tree.map(jnp.asarray, st), jax.tree.map(torch.tensor, st)
    valid = np.arange(x.shape[1])[None, :] < n[:, None]
    jy, js = jrwkv.apply_time_mix_paged(jp["tm"], jnp.asarray(x), jcfg,
                                        jst["tm"], jnp.asarray(n))
    ty, ts = rwkv6.apply_time_mix_paged(tp["tm"], torch.tensor(x), cfg,
                                        tst["tm"], torch.tensor(n))
    _close(ty[torch.tensor(valid)], np.asarray(jy)[valid])
    for key in ("S", "shift"):
        _close(ts[key], js[key])
        np.testing.assert_array_equal(ts[key][2].numpy(), st["tm"][key][2])
    jf, jc = jrwkv.apply_channel_mix_paged(jp["cm"], jnp.asarray(x),
                                           jst["cm"], jnp.asarray(n))
    tf, tc = rwkv6.apply_channel_mix_paged(tp["cm"], torch.tensor(x),
                                           tst["cm"], torch.tensor(n))
    _close(tf[torch.tensor(valid)], np.asarray(jf)[valid])
    _close(tc["shift"], jc["shift"])
    np.testing.assert_array_equal(tc["shift"][2].numpy(), st["cm"]["shift"][2])


def test_state_inits_match():
    jcfg = jax_config("recurrentgemma-9b").reduced()
    cfg = get_config("recurrentgemma-9b").reduced()
    js = jrglru.init_rglru_state(jcfg, 3, jnp.float32)
    ts = rglru.init_rglru_state(cfg, 3, torch.float32)
    assert {k: tuple(v.shape) for k, v in ts.items()} == \
        {k: v.shape for k, v in js.items()}
    jcfg, cfg = jax_config("rwkv6-3b").reduced(), get_config("rwkv6-3b").reduced()
    js, ts = jrwkv.init_rwkv_state(jcfg, 3), rwkv6.init_rwkv_state(cfg, 3)
    assert jax.tree.map(lambda a: tuple(a.shape), ts) == \
        jax.tree.map(lambda a: a.shape, js)
