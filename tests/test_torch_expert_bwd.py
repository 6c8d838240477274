"""The cotangent dtype at every compressed projection, on the CPU.

``sparse.ops.sparse_matmul`` takes the dtype its caller casts the product
to and casts inside its autograd function, so the backward kernels get the
cotangent in that dtype: bf16 where the caller casts to bf16 (the MoE
experts, ``layers.apply_proj``, the attention projections), f32 where the
product is kept in f32 (``apply_proj(..., f32=True)``, the compressed head
on f32 input). Here:

* a hook on the backward products records the cotangent's dtype at each
  call site, on the 'cuda' backend with CPU tensors (the kernel wrappers'
  plain versions, whose products come back in f32 as the kernels' do: the
  cast outside would widen a bf16 cotangent to f32 there);
* the gradients of x and of the block store with the cast inside equal,
  bit for bit, those with the cast outside (the widened cotangent holds
  the same bf16 values).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import attention, layers
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.compress import CompressionPlan, _pad_stack
from repro_torch.sparse.formats import dense_to_bcsr

BLOCK = (8, 16)


def _bcsr(rng, n, k, block=BLOCK, density=0.5):
    br, bc = block
    keep = rng.random((-(-n // br), -(-k // bc))) < density
    mask = np.kron(keep, np.ones(block, bool))[:n, :k]
    return dense_to_bcsr((rng.normal(size=(n, k)) * mask).astype(np.float32),
                         block)


def _stack(rng, e, n, k):
    return _pad_stack([_bcsr(rng, n, k) for _ in range(e)],
                      CompressionPlan(min_sparsity=0.0), (e,), 1 << 40)


class _Cotangents:
    """Within the block, every backward product of ``sparse_matmul``
    records the dtype of the cotangent it was handed."""

    def __init__(self, monkeypatch):
        self.dtypes = []
        for name in ("_dx_product", "_dw_product"):
            inner = getattr(sparse_ops, name)

            def hook(*args, inner=inner, dx=name == "_dx_product"):
                self.dtypes.append((args[0] if dx else args[1]).dtype)
                return inner(*args)
            monkeypatch.setattr(sparse_ops, name, hook)


def _bf16(t):
    return t.bfloat16() if t.is_floating_point() else t


def _train(t):
    return t.detach().clone().requires_grad_(True)


@pytest.mark.parametrize("site", ["proj", "proj_f32", "head", "attention",
                                  "moe"])
def test_cotangent_reaches_the_backward_in_the_cast_dtype(monkeypatch, site):
    """bf16 activations through each call site on the 'cuda' backend: the
    backward products get a bf16 cotangent where the site casts the
    product to bf16, an f32 one where it keeps the f32 product."""
    rng = np.random.default_rng(1)
    seen = _Cotangents(monkeypatch)
    backend = "cuda"
    if site in ("proj", "proj_f32", "head"):
        w = _bcsr(rng, 48, 64)
        w = dataclasses.replace(w, data=_train(w.data.bfloat16()))
        x = _train(torch.tensor(rng.normal(size=(2, 5, 64))).bfloat16())
        if site == "head":
            y = layers.apply_head({}, x, False, None, {"head": w}, backend)
        else:
            y = layers.apply_proj({}, x, "w", {"w": w}, backend,
                                  f32=site == "proj_f32")
        want = torch.bfloat16 if site == "proj" else torch.float32
        count = 2
    elif site == "attention":
        model = build("smollm-360m", reduced=True, device="cpu")
        cfg = dataclasses.replace(model.cfg, compute_dtype="bfloat16")
        p = model.init(torch.Generator().manual_seed(0))
        p = {k: _bf16(v[0]) for k, v in
             p["layers"]["b0_attn"]["attn"].items()}
        d, h, hd = cfg.d_model, cfg.n_heads, cfg.resolved_head_dim
        sparse = {name: _bcsr(rng, *shape) for name, shape in (
            ("wq", (h * hd, d)), ("wk", (cfg.n_kv_heads * hd, d)),
            ("wv", (cfg.n_kv_heads * hd, d)), ("wo", (d, h * hd)))}
        sparse = {k: dataclasses.replace(v, data=_train(v.data.bfloat16()))
                  for k, v in sparse.items()}
        x = _train(torch.tensor(rng.normal(size=(2, 8, d))).bfloat16())
        y = attention.apply_attention(p, x, cfg, torch.arange(8)[None],
                                      sparse, backend)
        want, count = torch.bfloat16, 8
    else:
        model = build("olmoe-1b-7b", reduced=True, device="cpu")
        cfg = model.cfg
        p = model.init(torch.Generator().manual_seed(0))
        p = {k: (_bf16(v[0]) if isinstance(v, torch.Tensor) else v)
             for k, v in p["layers"]["b0_attn"]["moe"].items()}
        e, d, ff = p["ewi"].shape
        sparse = {"ewi": _stack(rng, e, ff, d), "ewg": _stack(rng, e, ff, d),
                  "ewo": _stack(rng, e, d, ff)}
        sparse = {k: dataclasses.replace(v, data=_train(v.data.bfloat16()))
                  for k, v in sparse.items()}
        x = _train(torch.tensor(rng.normal(size=(2, 8, d))).bfloat16())
        y, _ = tmoe.apply_moe(p, x, cfg, sparse=sparse, backend=backend)
        want, count = torch.bfloat16, 6
    y.float().square().sum().backward()
    assert seen.dtypes == [want] * count, seen.dtypes
    assert x.grad is not None and x.grad.dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["ref", "cuda"])
@pytest.mark.parametrize("experts", [False, True])
def test_cast_inside_gives_the_gradients_of_the_cast_outside(backend,
                                                             experts):
    """``sparse_matmul(x, w, backend, bf16)`` against
    ``sparse_matmul(x, w, backend).to(bf16)`` (an expert stack with its
    counts, x zero past them): the same product and, bit for bit, the same
    gradients of x and of the block store."""
    rng = np.random.default_rng(2)
    if experts:
        w = _stack(rng, 3, 48, 64)
        rows = torch.tensor([0, 3, 5], dtype=torch.int32)
        keep = (torch.arange(5)[None, :] < rows[:, None].long())[..., None]
        x0 = torch.tensor(rng.normal(size=(3, 5, 64))) * keep
    else:
        w, rows = _bcsr(rng, 48, 64), None
        x0 = torch.tensor(rng.normal(size=(7, 64)))
    g = torch.tensor(rng.normal(size=x0.shape[:-1] + (48,)))
    runs = []
    for inside in (True, False):
        x = _train(x0.bfloat16())
        data = _train(w.data.bfloat16())
        wt = dataclasses.replace(w, data=data)
        if inside:
            y = sparse_ops.sparse_matmul(x, wt, backend, torch.bfloat16, rows)
        else:
            y = sparse_ops.sparse_matmul(x, wt, backend, rows=rows).to(
                torch.bfloat16)
        assert y.dtype == torch.bfloat16
        (y.float() * g).sum().backward()
        runs.append((y.detach(), x.grad, data.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
