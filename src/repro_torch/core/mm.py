"""MM baseline: learning-compression via the method of multipliers
(Carreira-Perpinan & Idelbayev 2018; paper section 4.4, Eq. (3)-(4)).
Port of ``repro.core.mm``.

The constrained problem  min L(w) + alpha*Psi(theta)  s.t. w = theta  is
solved on the augmented Lagrangian

    L(w) + (mu/2)||w - theta||^2 - lam^T (w - theta) + alpha*Psi(theta)

by alternating:
  (L-step)  SGD steps on w of L(w) + (mu/2)||w - theta - lam/mu||^2,
  (C-step)  theta <- prox_{(alpha/mu)*Psi}(w - lam/mu)   (closed form),
  (M-step)  lam <- lam - mu (w - theta),    mu <- mu * mu_growth every T steps.

Memory: (w, grad, theta, lam) -- about 2x the prox method's (w, grad) +
(m, v), the paper's Table 2 memory argument; ``mm_state_bytes`` reports
the state size.

This is plain PyTorch (the JAX package has no kernel here). As the port's
optimizers do, ``mm_update`` updates params, theta, lam and the momentum
IN PLACE and must run under ``torch.no_grad()``; it returns them. The
step counter and mu are host numbers: the cadences are host decisions, so
nothing syncs with the device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core.prox import default_regularized_predicate, soft_threshold
from repro_torch.core.metrics import tree_leaves
from repro_torch.core.tree import (flatten_with_path, keystr, map_with_keystr,
                                   tree_map)

PyTree = Any


class MMState(NamedTuple):
    step: int            # host int (the reference keeps an int32 scalar)
    theta: PyTree        # auxiliary (compressed) copy of the params
    lam: PyTree          # Lagrange multipliers
    mu: float            # penalty parameter (ramped to infinity), an f32 value
    momentum: PyTree     # SGD momentum buffer for the L-step


@dataclasses.dataclass(frozen=True)
class MMConfig:
    alpha: float = 1e-3          # regularization strength on theta
    mu0: float = 9.76e-5         # paper Table 2 (Lenet-5 setting)
    mu_growth: float = 1.1
    mu_every: int = 4000         # growth cadence (paper: x1.1 per 4k iters)
    c_step_every: int = 4000     # compression cadence (paper Fig. 8)
    learning_rate: float = 1e-2
    sgd_momentum: float = 0.9


def _f32(x: float) -> torch.Tensor:
    """``x`` as a host f32 scalar: the scalar arithmetic of the reference
    runs in f32."""
    return torch.tensor(x, dtype=torch.float32)


def mm_init(params: PyTree, cfg: MMConfig) -> MMState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return MMState(step=0,
                   theta=tree_map(lambda p: p.detach().float().clone(), params),
                   lam=tree_map(zeros, params), mu=float(_f32(cfg.mu0)),
                   momentum=tree_map(zeros, params))


def mm_update(grads: PyTree, state: MMState, params: PyTree, cfg: MMConfig,
              predicate: Optional[Callable] = None) -> tuple[PyTree, MMState]:
    """One MM iteration = one L-step SGD update (+ the C- and M-steps every
    ``c_step_every`` steps and the mu growth every ``mu_every``, counted on
    the step after the increment)."""
    predicate = predicate or default_regularized_predicate
    t = state.step + 1
    mu = state.mu
    do_c = t % cfg.c_step_every == 0
    do_mu = t % cfg.mu_every == 0

    flat_g = [g for _, g in flatten_with_path(grads)]
    flat_th = [x for _, x in flatten_with_path(state.theta)]
    flat_lm = [x for _, x in flatten_with_path(state.lam)]
    flat_mo = [x for _, x in flatten_with_path(state.momentum)]
    for (keys, p), g, th, lm, mo in zip(flatten_with_path(params), flat_g,
                                        flat_th, flat_lm, flat_mo):
        regular = predicate(keystr(keys), p)
        g_aug = g.float()
        if regular:
            # L-step gradient of L(w) + (mu/2)||w - theta - lam/mu||^2
            g_aug = g_aug + mu * (p.float() - th) - lm
        mo.mul_(cfg.sgd_momentum).add_(g_aug)
        w2 = p.float() - cfg.learning_rate * mo
        p.copy_(w2)
        if regular and do_c:
            # C-step: theta <- prox_{(alpha/mu) l1}(w - lam/mu); M-step
            th.copy_(soft_threshold(w2 - lm / mu,
                                    float(_f32(cfg.alpha) / _f32(mu))))
            lm.sub_(mu * (w2 - th))
    if do_mu:
        mu = float(_f32(mu) * _f32(cfg.mu_growth))
    return params, MMState(step=t, theta=state.theta, lam=state.lam, mu=mu,
                           momentum=state.momentum)


def mm_final_params(params: PyTree, state: MMState,
                    predicate: Optional[Callable] = None) -> PyTree:
    """At convergence MM returns theta (the compressed copy) for regularized
    leaves and w elsewhere."""
    predicate = predicate or default_regularized_predicate
    return map_with_keystr(
        lambda name, p, th: th.to(p.dtype) if predicate(name, p) else p,
        params, state.theta)


def mm_state_bytes(state: MMState) -> int:
    """Bytes of the state's tensors, plus the reference's two 4-byte
    scalars (step and mu)."""
    trees = (state.theta, state.lam, state.momentum)
    return 8 + sum(x.numel() * x.element_size()
                   for tree in trees for x in tree_leaves(tree))
