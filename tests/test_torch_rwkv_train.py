"""Training rwkv6-3b in the port against the JAX package, on the CPU:
reduced (two RWKV layers, d 64, one WKV head of 64, an untied head, f32),
from weights the JAX package made and block-pruned, carried across as
numpy (``torch_recurrent_train``).

Tolerances, with their reasons:
- the chunked WKV's VJP (torch's and XLA's einsums sum the same products
  in another order), every gradient within 1e-5 of its largest |value|;
- gradients at equal params within 1e-4 of each leaf's largest |g|;
- losses within 1e-5 relative at every step, grad_norm within 1e-5 at the
  first step of each phase; params within 2e-5 where every step's |g| >=
  1e-4, within lr a step elsewhere; zero patterns equal.
- grad_norm after a phase's first step within 5e-4 (1e-4 for the other
  families): at the third SpC step the two packages' grad_norm part by
  about 1.6e-4. In the pipeline, whose debias starts from each package's
  own compression, the parted params carry over and the gap grows: later
  losses within 5e-4 (1.2e-4 at the last debias step), grad_norm within
  1e-2 (3.0e-3 there) and the trained stores within 1e-3 of their norm
  (5.0e-4 for ``rwkv_k``'s, at most 7.6e-5 for the others).
  The leaves that part are the time mix's ``rwkv_k`` and ``rwkv_r``:
  elements whose |g| stays below 1e-4 take Adam steps of about lr
  whatever their |g|, and part by about 1e-6; the loss's gradient
  through the WKV's exponentials is sensitive to them.
  ``test_later_grad_norm_gap_is_parted_params`` shows that at the JAX
  params the port's grad_norm agrees within 1e-5 at each SpC step, and
  prints how much of the gap each parted leaf carries (``-s``); the
  pipeline test shows the same at each debias step.
- bf16: the loss within 2^-8 relative of the JAX package's; each leaf's
  bf16 gradient drift from its own package's f32 gradient within the
  reference's plus a quarter of it (``test_torch_bf16_drift.py``'s rule
  for logits).

The debias step's kernel path against its plain path is a ``gpu`` test in
``test_torch_gpu_kernels.py``, which imports no JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rwkv6 as jrwkv
from repro_torch.configs import get_config
from repro_torch.data import synthetic as tdata
from repro_torch.models import rwkv6
from test_torch_moe_train import RTOL, _data
from test_torch_train import _flat_np, _jflat_np
from torch_parity import to_port
from torch_recurrent_train import (Family, check_bf16_grad_drift,
                                   check_cli, check_dense_cli,
                                   check_grads_at_equal_params,
                                   check_no_dense_weight_grad,
                                   check_pipeline, check_plan_prox,
                                   check_spc_then_debias, grad_norm)

ARCH = "rwkv6-3b"
VJP_TOL = 1e-5
LATER_RTOL = 5e-4
PIPELINE_GN_RTOL = 1e-2
PIPELINE_STORE_RTOL = 1e-3
CLAMP = 25.0           # the chunked WKV's bound on |cumulative log-decay|


@pytest.fixture(scope="module")
def fam():
    return Family(ARCH, 64)


def _wkv_inputs(seed, s, b=2, h=2, hd=8, decay=(-5.0, -1.0), clamped=False):
    """r, k, v, logw (B, S, H, hd), u (H, hd), state (B, H, hd, hd) and the
    cotangents of both outputs. The per-step log-decays are -exp(U(decay))
    (at most 0.37 a step, so no 64-step chunk reaches the clamp) or, when
    ``clamped``, -U(0.3, 1.2), which passes it within a chunk while every
    exp(cumulative log-decay) stays a normal f32."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    r, k, v = (rng.normal(size=(b, s, h, hd)).astype(f32) for _ in range(3))
    if clamped:
        logw = -rng.uniform(0.3, 1.2, (b, s, h, hd)).astype(f32)
    else:
        logw = -np.exp(rng.uniform(*decay, (b, s, h, hd))).astype(f32)
    u = rng.normal(size=(h, hd)).astype(f32)
    state = rng.normal(size=(b, h, hd, hd)).astype(f32)
    cot = (rng.normal(size=(b, s, h, hd)).astype(f32),
           rng.normal(size=(b, h, hd, hd)).astype(f32))
    return (r, k, v, logw, u, state), cot


@jax.jit
def _jax_vjp(args, cot):
    out, vjp = jax.vjp(lambda *a: jrwkv.chunked_wkv(*a[:5], a[5] if a[5:]
                                                    else None), *args)
    return out, vjp(cot)


def _check_wkv_vjp(args, cot):
    """``chunked_wkv``'s VJP w.r.t. r, k, v, the log-decays, the bonus u
    and the carried state (when given), for cotangents of the output and
    the final state, against ``jax.vjp`` of the reference's."""
    (jo, js), want = _jax_vjp(tuple(map(jnp.asarray, args)),
                              tuple(map(jnp.asarray, cot)))
    leaves = [torch.tensor(a, requires_grad=True) for a in args]
    to, ts = rwkv6.chunked_wkv(*leaves[:5], leaves[5] if leaves[5:] else None)
    for got, ref in ((to, jo), (ts, js)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))
    got = torch.autograd.grad(
        (to * torch.tensor(cot[0])).sum() + (ts * torch.tensor(cot[1])).sum(),
        leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) <= VJP_TOL * scale


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [16, 64, 128, 192])
def test_chunked_wkv_vjp_matches_jax(s, carried):
    """A short sequence (one chunk of 16), one chunk of 64 (training's),
    and two and three chunks, whose inter-chunk state carries the
    gradient across chunks (training at seq 64 never does); from a zero
    state and from a carried one."""
    args, cot = _wkv_inputs(s, s)
    _check_wkv_vjp(args if carried else args[:5], cot)


@pytest.mark.parametrize("s", [64, 128])
def test_chunked_wkv_vjp_past_the_decay_clamp(s):
    """Log-decays whose cumulative sum passes -25 inside a chunk: there
    ``exp(-cum)`` is clamped at exp(25) in both packages and passes no
    gradient to the log-decays (``torch.clamp`` and ``jnp.clip`` agree
    except at exactly 25, where torch passes the whole gradient and
    ``jnp.clip`` half of it; these inputs do not hit it)."""
    args, cot = _wkv_inputs(7 + s, s, clamped=True)
    cum = np.cumsum(args[3].reshape(2, s // 64, 64, 2, 8), axis=2)
    assert (-cum > CLAMP).any() and (-cum < CLAMP).any()
    assert not (-cum == np.float32(CLAMP)).any()
    _check_wkv_vjp(args, cot)


@pytest.mark.parametrize("seq", [64, 128])
def test_grads_at_equal_params_match_jax(fam, seq):
    """3 SpC steps at one WKV chunk (S = 64) and two (S = 128), the JAX
    params carried across before each: every leaf's gradient, the time
    mix's decay LoRA, bonus and projections included."""
    worst = check_grads_at_equal_params(fam, seq)
    assert {"layers/b0_rwkv/tm/time_first", "layers/b0_rwkv/tm/lora_w/lora_a",
            "layers/b0_rwkv/tm/rwkv_k", "head"} <= worst.keys()


def test_spc_then_debias_steps_match_jax(fam):
    check_spc_then_debias(fam, later_rtol=LATER_RTOL)


def test_later_grad_norm_gap_is_parted_params(fam):
    """At each SpC step of the pipelines (``Family.runs``, seq 64) the
    port's grad_norm at the JAX package's params, carried across, agrees
    with the JAX step's within 1e-5 relative: the later steps' gap comes
    from the params the two runs reach, not from the gradient (the
    pipeline test shows the same for the debias steps). Printed (``-s``):
    per step the relative gap at the port's own params and at the JAX
    params, and at the third step, for each leaf that parts by more than
    1e-6, the port's grad_norm at the JAX params with only that leaf taken
    from the port's run."""
    run = fam.runs
    _, tcfg = _data(fam.jm, seq=fam.seq)
    for step, ((tparams, _, tmet), (jparams, _, jmet)) in enumerate(
            zip(run["tspc"], run["jspc"])):
        tb = tdata.token_batch(tcfg, step)
        at_jax = grad_norm(fam.tm, to_port(jparams), tb)
        want = float(jmet["grad_norm"])
        np.testing.assert_allclose(at_jax, want, rtol=RTOL)
        print(f"step {step + 1}: grad_norm {want:.7g} (JAX); the port at "
              f"its own params {float(tmet['grad_norm']) / want - 1:+.2e}, "
              f"at the JAX params {at_jax / want - 1:+.2e}")
        if step < 2:
            continue
        flat = _jflat_np(jparams)
        for path, value in _flat_np(tparams).items():
            if np.abs(value - flat[path]).max() <= 1e-6:
                continue
            mixed = to_port(jparams)
            node = mixed
            *head, leaf = path.split("/")
            for key in head:
                node = node[key]
            node[leaf] = torch.tensor(value)
            print(f"  only {path} from the port: "
                  f"{grad_norm(fam.tm, mixed, tb) / want - 1:+.2e}")


@pytest.mark.parametrize("path,shape,eligible", [
    ("['layers']['b0_rwkv']['tm']['rwkv_r']", (2, 64, 64), True),
    ("['layers']['b1_rwkv']['tm']['rwkv_o']", (2, 64, 64), True),
    ("['layers']['b0_rwkv']['cm']['cm_k']", (2, 64, 128), True),
    ("['layers']['b0_rwkv']['cm']['cm_v']", (2, 128, 64), True),
    ("['layers']['b1_rwkv']['cm']['cm_r']", (2, 64, 64), True),
    ("['head']", (64, 128), True),
    ("['layers']['b0_rwkv']['tm']['lora_w']['lora_a']", (2, 64, 32), False),
])
def test_plan_prox_matches_jax(path, shape, eligible):
    """The plan prox on rwkv's stacked time-mix and channel-mix
    projections and its untied head; the decay LoRA is no target."""
    check_plan_prox(path, shape, eligible)


def test_spc_retrain_pipeline_matches_jax(fam):
    check_pipeline(fam, later_rtol=LATER_RTOL,
                   later_gn_rtol=PIPELINE_GN_RTOL,
                   store_rtol=PIPELINE_STORE_RTOL)


def test_sparse_cli_resumed_from_planted_checkpoint_matches_jax(
        fam, tmp_path, capsys):
    check_cli(fam, tmp_path, capsys)


def test_dense_spc_cli_trains_rwkv(capsys):
    check_dense_cli(ARCH, capsys)


def test_debias_step_makes_no_dense_weight_gradient(monkeypatch):
    """With a width (128: two WKV heads of 64), a channel-mix width (192)
    and a vocab (160) that no activation of the step shares."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), d_model=128,
                              d_ff=192, vocab=160)
    check_no_dense_weight_grad(cfg, monkeypatch)


def test_bf16_training_step_runs_and_tracks_jax(fam):
    """A bf16 training step of reduced rwkv (the f32 masters of rank >= 2
    cast to bf16, the decay LoRA's included, which the port's LoRA product
    takes in f32). The loss agrees with the JAX package's within 2^-8
    relative (one bf16 rounding of the logits). Two packages that round at
    different places do not give the same bf16 gradients, so, as
    ``test_torch_bf16_drift.py`` does for logits, each package's bf16
    gradient is compared with its own f32 gradient at the same params:
    for every leaf, the port's error over the leaf's largest f32 |g| is
    held to the reference's plus a quarter of it (at least 2^-8). A
    bf16-only fault in the port shows as a larger drift; the WKV's
    exponentials amplify every rounding of r, k and v, which both
    packages therefore take unrounded (the reference as XLA compiles it:
    run with ``XLA_FLAGS=--xla_allow_excess_precision=false`` and ``-s``
    to see the reference's drift with every bf16 round trip of its code
    kept). Printed (``-s``): each leaf's two drifts."""
    check_bf16_grad_drift(ARCH, fam.jp)
