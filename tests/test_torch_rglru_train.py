"""Training recurrentgemma-9b's RG-LRU hybrid in the port against the JAX
package, on the CPU: reduced (one (rglru, rglru, attn) super-block and two
remainder RG-LRU layers, d 64, f32), from weights the JAX package made and
block-pruned, carried across as numpy (``torch_recurrent_train``).

Tolerances, with their reasons:
- the scan's VJP (the port's doubling scan against the reference's
  ``associative_scan``: the same products summed in another order), every
  gradient within 1e-5 of its largest |value|;
- gradients at equal params within 1e-4 of each leaf's largest |g|;
- losses within 1e-5 relative at every step, grad_norm within 1e-5 at the
  first step of each phase and 1e-4 after it (Adam parts params where a
  step's |g| is near zero, ``_assert_params``); params within 2e-5 where
  every step's |g| >= 1e-4, within lr a step elsewhere; zero patterns equal.

The debias step's kernel path against its plain path is a ``gpu`` test in
``test_torch_gpu_kernels.py``, which imports no JAX.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro_torch.configs import get_config
from repro_torch.models import rglru
from torch_recurrent_train import (Family, check_cli, check_dense_cli,
                                   check_grads_at_equal_params,
                                   check_no_dense_weight_grad,
                                   check_pipeline, check_plan_prox,
                                   check_spc_then_debias)

ARCH = "recurrentgemma-9b"
SEQ = 48
VJP_TOL = 1e-5
CLAMP = 1e-12          # the floor of 1 - a^2 under the square root


@pytest.fixture(scope="module")
def fam():
    return Family(ARCH, SEQ)


def _scan_inputs(seed, s, w=24, b=3, gate_b_a=None):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"gate_w_a": rng.normal(size=w).astype(f32),
         "gate_b_a": (rng.normal(size=w) if gate_b_a is None
                      else gate_b_a).astype(f32),
         "gate_w_x": rng.normal(size=w).astype(f32),
         "gate_b_x": rng.normal(size=w).astype(f32),
         "rglru_a_param": (np.linspace(-2.0, 1.0, w)
                           + 0.1 * rng.normal(size=w)).astype(f32)}
    u = rng.normal(size=(b, s, w)).astype(f32)
    h0 = rng.normal(size=(b, w)).astype(f32)
    cot = (rng.normal(size=(b, s, w)).astype(f32),
           rng.normal(size=(b, w)).astype(f32))
    return p, u, h0, cot


@jax.jit
def _jax_vjp(args, cot):
    out, vjp = jax.vjp(jrglru.rglru_scan, *args)
    return out, vjp(cot)


def _check_scan_vjp(p, u, h0, cot):
    """``rglru_scan``'s VJP w.r.t. the gate and decay params, u and h0
    (when given), for cotangents of both outputs (h and the last state),
    against ``jax.vjp`` of the reference's."""
    args = (p, u) + ((h0,) if h0 is not None else ())
    (jh, jl), want = _jax_vjp(jax.tree.map(jnp.asarray, args),
                              tuple(map(jnp.asarray, cot)))
    want = jax.tree.leaves(want)
    leaves = [torch.tensor(a, requires_grad=True)
              for a in jax.tree.leaves(args)]
    targs = jax.tree.unflatten(jax.tree.structure(args), leaves)
    th, tl = rglru.rglru_scan(*targs)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               atol=1e-5, rtol=1e-5)
    got = torch.autograd.grad(
        (th * torch.tensor(cot[0])).sum() + (tl * torch.tensor(cot[1])).sum(),
        leaves)
    for g, w in zip(got, want):
        w = np.asarray(w)
        scale = float(np.abs(w).max())
        assert float(np.abs(g.numpy() - w).max()) <= VJP_TOL * scale


@pytest.mark.parametrize("carried", [False, True])
@pytest.mark.parametrize("s", [1, 7, 48, 64])
def test_rglru_scan_vjp_matches_jax(s, carried):
    """One step, a length no power of two divides, the training length
    and a power of two; from a zero state and from a carried one."""
    p, u, h0, cot = _scan_inputs(s, s)
    _check_scan_vjp(p, u, h0 if carried else None, cot)


def test_rglru_scan_vjp_at_the_sqrt_clamp():
    """Channels whose recurrence gate is below 1e-20 (a gate bias of -60)
    have a = 1 in f32, so 1 - a^2 = 0 sits under the 1e-12 floor of the
    square root: there neither package passes a gradient through 1 - a^2
    (``torch.clamp`` and ``jnp.maximum`` agree strictly below the floor;
    they part only at exactly 1e-12, where torch's clamp passes the whole
    gradient and ``jnp.maximum`` half of it, a value these inputs do not
    hit). The VJPs agree as elsewhere."""
    w = 24
    gate_b_a = np.where(np.arange(w) % 2 == 0, -60.0, 0.5)
    p, u, h0, cot = _scan_inputs(5, 48, w=w, gate_b_a=gate_b_a)
    a_sq = np.exp(2.0 * -8.0 * np.logaddexp(0, p["rglru_a_param"])
                  / (1 + np.exp(-(p["gate_w_a"] * u + p["gate_b_a"]))),
                  dtype=np.float32)
    under = (1.0 - a_sq) < CLAMP
    assert under[..., ::2].all() and not under[..., 1::2].any()
    assert not ((1.0 - a_sq) == np.float32(CLAMP)).any()
    _check_scan_vjp(p, u, h0, cot)


def test_grads_at_equal_params_match_jax(fam):
    """3 SpC steps at S = 48 (the JAX params carried across before each):
    every leaf's gradient, the stacked ``layers/b*_rglru`` and 2-D
    ``rem/r*_rglru`` recurrences included."""
    worst = check_grads_at_equal_params(fam, SEQ)
    assert any("/rec/" in k for k in worst) and any(
        k.startswith("rem/") for k in worst)


def test_spc_then_debias_steps_match_jax(fam):
    check_spc_then_debias(fam)


@pytest.mark.parametrize("path,shape", [
    ("['layers']['b0_rglru']['rec']['lru_in']", (2, 64, 96)),
    ("['layers']['b1_rglru']['rec']['lru_out']", (2, 96, 64)),
    ("['layers']['b0_rglru']['mlp']['wi']", (2, 64, 128)),
    ("['rem']['r0_rglru']['rec']['lru_gate']", (64, 96)),
    ("['rem']['r1_rglru']['rec']['lru_out']", (96, 64)),
    ("['rem']['r0_rglru']['mlp']['wo']", (128, 64)),
])
def test_plan_prox_matches_jax(path, shape):
    """The plan prox on recurrentgemma's stacked (super-block axis first)
    and 2-D remainder recurrences and MLPs."""
    check_plan_prox(path, shape)


def test_plan_prox_leaves_the_conv_alone():
    """The depthwise conv (cw, w) is no prox target."""
    check_plan_prox("['rem']['r0_rglru']['rec']['conv1d']", (16, 64),
                    eligible=False)


def test_spc_retrain_pipeline_matches_jax(fam):
    check_pipeline(fam)


def test_sparse_cli_resumed_from_planted_checkpoint_matches_jax(
        fam, tmp_path, capsys):
    check_cli(fam, tmp_path, capsys)


def test_dense_spc_cli_trains_the_hybrid(capsys):
    check_dense_cli(ARCH, capsys)


def test_debias_step_makes_no_dense_weight_gradient(monkeypatch):
    """With an LRU width (96) and a vocab (160) that no other tensor has."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), lru_width=96,
                              vocab=160)
    check_no_dense_weight_grad(cfg, monkeypatch)
