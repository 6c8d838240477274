"""The port's spmm and palette-spmm against the JAX package's Pallas
kernels (interpret mode on the CPU). The CUDA kernels are held against
these plain versions in test_torch_gpu_kernels.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.bsr_spmm import ops as jops
from repro.sparse.compress import quantize_bcsr as jax_quantize_bcsr
from repro.sparse.formats import dense_to_bcsr as jax_dense_to_bcsr
from repro_torch.kernels.bsr_spmm import ops, ref
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.formats import dense_to_bcsr
from torch_parity import block_sparse, port_format

SHAPES = [(64, 128, (8, 128)), (96, 160, (32, 32))]
DENSITIES = [0.0, 0.3, 1.0]
# f32 accumulation of the same products in another order: the JAX kernel
# tests' tolerance
ATOL, RTOL = 2e-4, 1e-4


@pytest.mark.parametrize("n,k,block", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_spmm_matches_pallas(n, k, block, density, dtype):
    rng = np.random.default_rng(7)
    w = block_sparse(rng, n, k, block, density)
    jm = jax_dense_to_bcsr(w, block)
    xj = jnp.asarray(rng.normal(size=(16, k)), getattr(jnp, dtype))
    want = np.asarray(jops.spmm(xj, jm, bm=8), np.float32)
    xt = torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))
    got = ops.spmm(xt, port_format(jm))
    assert got.dtype == torch.float32 and got.shape == (16, n)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("n,k,block", SHAPES)
@pytest.mark.parametrize("density", DENSITIES)
@pytest.mark.parametrize("bits", [8, 4])
def test_spmm_palette_matches_pallas(n, k, block, density, bits):
    rng = np.random.default_rng(8)
    jq = jax_quantize_bcsr(jax_dense_to_bcsr(block_sparse(rng, n, k, block,
                                                          density), block), bits)
    x = rng.normal(size=(16, k)).astype(np.float32)
    want = np.asarray(jops.spmm_palette(jnp.asarray(x), jq, bm=8))
    got = ops.spmm_palette(torch.tensor(x), port_format(jq))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_schedule_oracle_matches_spmm():
    rng = np.random.default_rng(9)
    w = block_sparse(rng, 64, 96, (32, 32), 0.5)
    m = dense_to_bcsr(w, (32, 32))
    x = torch.tensor(rng.normal(size=(12, 96)), dtype=torch.float32)
    got = ref.gather_block_matmul_ref(x, m.data, m.gather_idx, m.gather_blk,
                                      m.gather_nnz, out_cols=64,
                                      transpose_block=True)
    np.testing.assert_allclose(got.numpy(), ref.spmm_fwd_ref(x, m).numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), x.numpy() @ w.T, atol=1e-4)


def test_sparse_matmul_dispatch_and_backward_guard():
    w = block_sparse(np.random.default_rng(10), 64, 128, (8, 128), 0.5)
    m = dense_to_bcsr(w, (8, 128))
    x = torch.randn(4, 128)
    assert sparse_ops.resolve_backend("auto", x) == "ref"
    assert sparse_ops.resolve_backend("cuda", x) == "cuda"
    with pytest.raises(ValueError):
        sparse_ops.resolve_backend("pallas", x)
    y_ref = sparse_ops.sparse_matmul(x, m)
    y_wrapper = sparse_ops.sparse_matmul(x, m, backend="cuda")  # CPU: plain
    np.testing.assert_allclose(y_ref.numpy(), y_wrapper.numpy(), atol=1e-6)
    xb = x.bfloat16()
    assert sparse_ops.sparse_matmul(xb, m).dtype == torch.bfloat16  # ref: x's dtype
    xg = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        sparse_ops.sparse_matmul(xg, m).sum().backward()


def test_wrapper_rejects_other_devices():
    m = dense_to_bcsr(np.ones((8, 128), np.float32), (8, 128))
    with pytest.raises(ValueError):
        ops.spmm(torch.empty(4, 128, device="meta"), m)
