"""The backward of ``sparse_matmul`` in the port against the JAX package,
on the CPU: the plain ``spmm_t`` against JAX ``ops.spmm_t`` (Pallas in
interpret mode), the plain SDDMM against ``bsr_weight_grad`` (interpret
mode), and ``sparse_matmul``'s dx and dw against ``jax.grad`` through the
JAX ``custom_vjp``. Inputs come from numpy with a seed.

Tolerances: f32 products agree to 1e-4 absolute (sums of up to a few
hundred products of unit-normal values, summed in another order); with a
bf16 block store dw is rounded to bf16 on both sides, so it agrees to one
bf16 step of its largest entry (2**-7 of max |dw|).

A ``TorchDispatchMode`` recorder checks that the plain dw path never makes
a tensor of the dense (N, K) weight's shape: the torch-side form of the
reference's jaxpr property (ROADMAP Queue 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels.bsr_sddmm import ops as jsddmm
from repro.kernels.bsr_spmm import ops as jspmm
from repro.sparse import formats as jf
from repro.sparse import ops as jops
from repro_torch.kernels.bsr_sddmm import ops as sddmm
from repro_torch.kernels.bsr_spmm import ops as spmm
from repro_torch.sparse import ops
from torch_parity import block_sparse, port_format

CASES = [  # (n, k, block, density)
    (64, 96, (8, 32), 0.4), (40, 72, (8, 16), 0.6), (96, 960 // 8, (8, 128), 0.5),
    (64, 64, (32, 32), 0.05), (24, 100, (4, 16), 0.5),
]


def _inputs(n, k, block, density, seed, m=12):
    rng = np.random.default_rng(seed)
    w = block_sparse(rng, n, k, block, density)
    x = rng.normal(size=(m, k)).astype(np.float32)
    dy = rng.normal(size=(m, n)).astype(np.float32)
    return jf.dense_to_bcsr(w, block), x, dy


@pytest.mark.parametrize("n,k,block,density", CASES)
def test_spmm_t_matches_pallas(n, k, block, density):
    jm, x, dy = _inputs(n, k, block, density, 0)
    want = jspmm.spmm_t(jnp.asarray(dy), jm, bm=8)
    got = spmm.spmm_t(torch.tensor(dy), port_format(jm))
    assert got.dtype == torch.float32 and got.shape == (dy.shape[0], k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def _padded(jm, extra=3):
    return jf.pad_bcsr(jm, jm.data.shape[0] + extra, jm.gather_idx.shape[1] + 1,
                       jm.gather_t_idx.shape[1] + 2)


@pytest.mark.parametrize("case", ["plain", "pad_slots", "empty", "ragged_m"])
@pytest.mark.parametrize("n,k,block,density", CASES[:3])
def test_sddmm_matches_pallas(n, k, block, density, case):
    jm, x, dy = _inputs(n, k, block, density, 1,
                        m=13 if case == "ragged_m" else 12)
    if case == "pad_slots":
        jm = _padded(jm)
    if case == "empty":
        jm = _padded(jf.dense_to_bcsr(np.zeros((n, k), np.float32), block))
    want = jsddmm.bsr_weight_grad(jnp.asarray(x), jnp.asarray(dy), jm, bm=8)
    tm = port_format(jm)
    got = sddmm.bsr_weight_grad(torch.tensor(x), torch.tensor(dy), tm)
    assert got.shape == tuple(jm.data.shape) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    rows, cols, valid = sddmm.slot_coordinates(tm)
    jr, jc, jv = jsddmm.slot_coordinates(jm)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(cols.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
    assert not valid[0] and (got[~valid] == 0).all()
    if case == "empty":
        assert (got == 0).all()


@pytest.mark.parametrize("n,k,block,density", CASES[:3])
def test_slot_coordinates_cached_per_table(n, k, block, density):
    """The coordinates are computed once per gather table: layer views of
    one stacked store hit, another store misses, and an in-place change to
    a table recomputes them, equal to the reference's."""
    jm, _, _ = _inputs(n, k, block, density, 4)
    jp = _padded(jm)
    stacked = port_format(jp).map(lambda t: torch.stack([t, t.clone()]))
    layers = [stacked[i] for i in range(2)]
    first = sddmm.slot_coordinates(layers[0])
    assert sddmm.slot_coordinates(stacked[0])[0] is first[0]
    other = sddmm.slot_coordinates(layers[1])
    assert other[0] is not first[0]
    for got, want in zip(other, jsddmm.slot_coordinates(jp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # move every gather entry of block-row 0 to the pad slot
    stacked.gather_blk[0, 0].zero_()
    redone = sddmm.slot_coordinates(stacked[0])
    assert redone[0] is not first[0]
    want = jsddmm.slot_coordinates(dataclasses.replace(
        jp, gather_blk=jp.gather_blk.at[0].set(0)))
    for got, w in zip(redone, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_sddmm_rejects_palette():
    jm, x, dy = _inputs(64, 96, (8, 32), 0.4, 2)
    from repro.sparse import compress as jc
    pal = port_format(jc.quantize_bcsr(jm, 8))
    with pytest.raises(TypeError, match="PaletteBCSR"):
        sddmm.bsr_weight_grad(torch.tensor(x), torch.tensor(dy), pal)


@pytest.mark.parametrize("data_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,k,block,density", CASES[:3])
def test_sparse_matmul_grads_match_jax(n, k, block, density, data_dtype):
    """dx and dw of sum(y * c) through the port's autograd Function against
    ``jax.grad`` through the reference's custom VJP."""
    jm, x, _ = _inputs(n, k, block, density, 3)
    tm = port_format(jm)                   # numpy carries no bf16: cast here
    tm = dataclasses.replace(tm, data=tm.data.to(getattr(torch, data_dtype)))
    jm = dataclasses.replace(jm, data=jm.data.astype(getattr(jnp, data_dtype)))
    c = np.random.default_rng(4).normal(size=(x.shape[0], n)).astype(np.float32)

    def jloss(xx, data):
        y = jops.sparse_matmul(xx, dataclasses.replace(jm, data=data), "ref")
        return jnp.sum(y.astype(jnp.float32) * c)

    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jm.data)
    data = tm.data.clone().requires_grad_(True)
    tx = torch.tensor(x, requires_grad=True)
    y = ops.sparse_matmul(tx, dataclasses.replace(tm, data=data))
    (y.float() * torch.tensor(c)).sum().backward()
    assert data.grad.dtype == data.dtype and tx.grad.dtype == torch.float32
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-4)
    want = np.asarray(jdw.astype(jnp.float32))
    tol = 1e-4 if data_dtype == "float32" else 2 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(data.grad.float().numpy(), want, atol=tol)


def test_weight_only_gradient_gate():
    """x without grad, data with grad: the Function still runs (debias
    trains the block store whatever the input)."""
    jm, x, _ = _inputs(64, 96, (8, 32), 0.4, 5)
    tm = port_format(jm)
    data = tm.data.clone().requires_grad_(True)
    y = ops.sparse_matmul(torch.tensor(x), dataclasses.replace(tm, data=data))
    y.sum().backward()
    assert data.grad is not None and data.grad.abs().sum() > 0


def test_palette_dx_matches_jax():
    from repro.sparse import compress as jc
    jm, x, _ = _inputs(64, 96, (8, 32), 0.6, 6)
    jp = jc.quantize_bcsr(jm, 4)
    c = np.random.default_rng(7).normal(size=(x.shape[0], 64)).astype(np.float32)
    jdx = jax.grad(lambda xx: jnp.sum(jops.sparse_matmul(xx, jp, "ref") * c))(
        jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    (ops.sparse_matmul(tx, port_format(jp)) * torch.tensor(c)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-4)
    np.testing.assert_allclose(
        ops.sparse_matmul_t(torch.tensor(c), port_format(jp)).numpy(),
        np.asarray(jops.sparse_matmul_t(jnp.asarray(c), jp, "ref")), atol=1e-4)


class _Shapes(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.shapes.add(tuple(t.shape))
        return out


def test_plain_dw_makes_no_dense_weight_gradient():
    n, k, block = 40, 72, (8, 16)
    jm, x, _ = _inputs(n, k, block, 0.5, 8)
    tm = port_format(jm)
    data = tm.data.clone().requires_grad_(True)
    y = ops.sparse_matmul(torch.tensor(x), dataclasses.replace(tm, data=data))
    rec = _Shapes()
    with rec:
        y.sum().backward()
    assert data.grad is not None
    r_grid, c_grid = tm.block_grid
    dense_shapes = {(n, k), (k, n), (r_grid * block[0], c_grid * block[1])}
    assert not rec.shapes & dense_shapes, rec.shapes


@pytest.mark.parametrize("n,k,block,density", CASES[:2])
def test_sparse_matmul_t_matches_jax(n, k, block, density):
    jm, _, dy = _inputs(n, k, block, density, 9)
    np.testing.assert_allclose(
        ops.sparse_matmul_t(torch.tensor(dy), port_format(jm)).numpy(),
        np.asarray(jops.sparse_matmul_t(jnp.asarray(dy), jm, "ref")), atol=1e-4)
