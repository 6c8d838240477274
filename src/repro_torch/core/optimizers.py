"""Prox-RMSProp (paper Alg. 1), Prox-ADAM (paper Alg. 2) and Prox-SGD.

Port of ``repro.core.optimizers``. Each update is

    step:  d_t from the base rule (SGD / RMSProp / ADAM)
    w_t <- prox_{eta_t * lambda}( w_{t-1} - eta_t * d_t )

with the threshold ``eta_t * lambda`` of the paper's Algorithms 1-2;
``lambda`` and the learning rate may be schedules (``core.schedule``). A
``mask`` tree (0/1 per element) serves the debias phase: it multiplies the
grads before the step and the params after it, so masked entries stay
zero.

The port updates params and moments IN PLACE (JAX returns new trees and
donates the old ones); ``update`` must run under ``torch.no_grad()``, as
``train.step`` does. Under ``prox_adam`` and ``prox_rmsprop`` the step ``z
= p - eta*d`` of every leaf goes through one call of ``kernels/prox_adam``'s
``fused_tree_update``, with the soft threshold inside on each leaf where
the prox is l1 and the predicate holds: one kernel launch a step for a
CUDA tree of up to ``fused_ops.K`` leaves, the plain version leaf by leaf
for a CPU tree. After it, leaf by leaf, the path-aware or group-l1 prox
runs on the result (under a rank mesh, on the whole leaf: gathered,
thresholded, and this rank's part taken back) and the mask multiplies.
The f32 gradients of all leaves are held until that call: a step's peak
memory holds them together. ``prox_sgd`` has no kernel: its step is the
plain ``direction`` arithmetic here, leaf by leaf.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.core import prox as prox_lib
from repro_torch.core.tree import flatten_with_path, keypath, keystr, tree_map
from repro_torch.kernels.prox_adam import ops as fused_ops

PyTree = Any
Schedule = Callable[[Any], Any]


def _as_schedule(v) -> Schedule:
    if callable(v):
        return v
    return lambda step: torch.tensor(v, dtype=torch.float32)


class ProxState(NamedTuple):
    step: int           # host int (the reference keeps an int32 scalar)
    m: PyTree           # 1st moment (zeros tree for rmsprop / sgd)
    v: PyTree           # 2nd moment (zeros tree for sgd)


@dataclasses.dataclass(frozen=True)
class ProxOptimizer:
    """An (init, update) pair; ``update`` returns (params, state)."""
    init: Callable[[PyTree], ProxState]
    update: Callable[..., tuple[PyTree, ProxState]]
    name: str = "prox_opt"


def _make(name: str, learning_rate, lam, prox_name: str = "l1",
          prox_kwargs: Optional[dict] = None,
          prox_fn: Optional[Callable] = None, regularized_predicate=None,
          weight_decay: float = 0.0, *, kernel: Optional[dict] = None,
          direction_fn: Optional[Callable] = None) -> ProxOptimizer:
    """``prox_fn`` overrides the registry lookup; a prox accepting a
    ``path`` keyword is called with the leaf's keystr path (the hook
    ``sparse.compress.make_plan_prox`` uses). A rule gives either
    ``kernel``, the fused kernel's rule and its (b1, b2, eps), or
    ``direction_fn``, its plain step direction."""
    lr_s = _as_schedule(learning_rate)
    lam_s = _as_schedule(lam)
    elementwise_l1 = prox_fn is None and prox_name == "l1"
    if prox_fn is None:
        prox_fn = prox_lib.get_prox(prox_name, **(prox_kwargs or {}))
    try:
        path_aware = "path" in inspect.signature(prox_fn).parameters
    except (TypeError, ValueError):
        path_aware = False
    predicate = regularized_predicate or prox_lib.default_regularized_predicate

    def init(params: PyTree) -> ProxState:
        z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        return ProxState(step=0, m=tree_map(z, params), v=tree_map(z, params))

    def update(grads: PyTree, state: ProxState, params: PyTree,
               mask: Optional[PyTree] = None) -> tuple[PyTree, ProxState]:
        t = state.step + 1
        eta = lr_s(t)
        tau = eta * lam_s(t)
        scalars = None
        if kernel is not None:
            scalars = fused_ops.make_scalars(eta, lam_s(t), kernel["b1"],
                                             kernel["b2"], kernel["eps"], t)
        flat_g = [g for _, g in flatten_with_path(grads)]
        flat_m = [m for _, m in flatten_with_path(state.m)]
        flat_v = [v for _, v in flatten_with_path(state.v)]
        flat_k = ([k for _, k in flatten_with_path(mask)] if mask is not None
                  else [None] * len(flat_g))

        def finish(p, z, mk):
            if z is not p:
                p.copy_(z)
            if mk is not None:
                p.mul_(mk.to(p.dtype))

        leaves = []
        for (keys, p), g, m, v, mk in zip(flatten_with_path(params), flat_g,
                                          flat_m, flat_v, flat_k):
            name = keystr(keys)
            if mk is not None:
                g = g * mk.to(g.dtype)
            regular = predicate(name, p)
            g32 = g.float()
            if weight_decay:
                g32 = g32 + weight_decay * p.float()
            if kernel is not None:
                leaves.append((name, p, g32, m, v, mk, regular))
                continue
            d, m2, v2 = direction_fn(g32, m, v, t)
            z = p.float() - eta * d
            if regular:
                z = _whole_leaf(prox_fn, z, tau, name, path_aware)
            if m2 is not m:
                m.copy_(m2)
            finish(p, z, mk)
        if kernel is not None:
            # every leaf's step in one call: one launch on the card for a
            # tree of up to fused_ops.K leaves
            fused_ops.fused_tree_update(
                [x[1] for x in leaves], [x[2] for x in leaves],
                [x[3] for x in leaves], [x[4] for x in leaves], scalars,
                rule=kernel["rule"],
                prox=[x[6] and elementwise_l1 for x in leaves])
            for name, p, _, _, _, mk, regular in leaves:
                z = p
                if regular and not elementwise_l1:
                    z = _whole_leaf(prox_fn, p, tau, name, path_aware)
                finish(p, z, mk)
        return params, ProxState(step=t, m=state.m, v=state.v)

    return ProxOptimizer(init=init, update=update, name=name)


def _whole_leaf(prox_fn, z, tau, name: str, path_aware: bool):
    """``prox_fn`` on the whole leaf: under a rank mesh a leaf split over
    some axes is gathered first and this rank's part taken from the
    result, so a block that a split cuts in two is thresholded by its
    whole norm."""
    from repro_torch.distributed import sharding
    call = ((lambda t: prox_fn(t, tau, path=name)) if path_aware
            else (lambda t: prox_fn(t, tau)))
    mesh = sharding.current_mesh()
    if mesh is None:
        return call(z)
    return sharding.on_whole_leaf(call, z, keypath(name), mesh)


# ---------------------------------------------------------------------------
# The three rules
# ---------------------------------------------------------------------------

def prox_sgd(learning_rate, lam=0.0, momentum: float = 0.0,
             **kw) -> ProxOptimizer:
    """Prox-SGD (stochastic proximal gradient, paper Eq. (2))."""
    def direction(g, m, v, t):
        if momentum:
            m2 = momentum * m + g
            return m2, m2, v
        return g, m, v
    return _make("prox_sgd", learning_rate, lam, direction_fn=direction, **kw)


def prox_rmsprop(learning_rate, lam=0.0, beta: float = 0.9,
                 eps: float = 1e-8, **kw) -> ProxOptimizer:
    """Prox-RMSProp, paper Algorithm 1:
    v_t = beta*v + (1-beta)*g^2 ; w <- prox(w - eta * g/(sqrt(v_t)+eps))."""
    return _make("prox_rmsprop", learning_rate, lam,
                 kernel={"rule": "rmsprop", "b1": 0.0, "b2": beta,
                         "eps": eps}, **kw)


def prox_adam(learning_rate, lam=0.0, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8, **kw) -> ProxOptimizer:
    """Prox-ADAM, paper Algorithm 2 (with bias correction)."""
    return _make("prox_adam", learning_rate, lam,
                 kernel={"rule": "adam", "b1": b1, "b2": b2, "eps": eps}, **kw)


_REGISTRY = {"prox_sgd": prox_sgd, "prox_rmsprop": prox_rmsprop,
             "prox_adam": prox_adam, "sgd": prox_sgd,
             "rmsprop": prox_rmsprop, "adam": prox_adam}


def get_optimizer(name: str, **kwargs) -> ProxOptimizer:
    if name not in _REGISTRY:
        raise ValueError(f"unknown optimizer {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
