"""The CUDA kernels of repro_torch against their plain PyTorch versions.

Marked ``gpu``: each test decides inside itself whether a card is present
and skips without one. The file imports no JAX, so it also runs where JAX
is not installed:

    python -m pytest -m gpu tests/test_torch_gpu_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bsr_spmm import ops, ref
from repro_torch.sparse.compress import quantize_bcsr
from repro_torch.sparse.formats import dense_to_bcsr

# f32 accumulation of the same products in another order
ATOL, RTOL = 2e-4, 1e-4
KERNEL_SHAPES = [(960, 960, (8, 128)), (2560, 960, (8, 128)),
                 (960, 2560, (8, 128)), (64, 128, (8, 64)),
                 (96, 160, (32, 32)), (128, 64, (16, 16)), (100, 70, (8, 64))]


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _block_sparse(rng, n, k, block, density):
    """(n, k) f32 with each (br, bc) block (ragged at the edges) nonzero
    with probability ``density``."""
    br, bc = block
    keep = rng.random((-(-n // br), -(-k // bc))) < density
    mask = np.kron(keep, np.ones(block, bool))[:n, :k]
    return (rng.normal(size=(n, k)) * mask).astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("density", [0.0, 0.1, 1.0])
@pytest.mark.parametrize("m", [1, 4, 33, 512])
def test_cuda_spmm_matches_plain(n, k, block, density, m):
    dev = _cuda()
    rng = np.random.default_rng(11)
    w = dense_to_bcsr(_block_sparse(rng, n, k, block, density), block).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.tensor(rng.normal(size=(m, k)), dtype=dtype, device=dev)
        before = ops.launches["spmm"]
        got = ops.spmm(x, w)
        assert ops.launches["spmm"] == before + 1
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.spmm_fwd_ref(x, w), atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.gpu
@pytest.mark.parametrize("n,k,block", KERNEL_SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("m", [4, 512])
def test_cuda_spmm_palette_matches_plain(n, k, block, bits, m):
    dev = _cuda()
    rng = np.random.default_rng(12)
    q = quantize_bcsr(dense_to_bcsr(_block_sparse(rng, n, k, block, 0.2),
                                    block).to(dev), bits)
    x = torch.tensor(rng.normal(size=(m, k)), dtype=torch.bfloat16, device=dev)
    before = ops.launches["spmm_palette"]
    got = ops.spmm_palette(x, q)
    assert ops.launches["spmm_palette"] == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.spmm_palette_fwd_ref(x, q), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.gpu
def test_cuda_spmm_takes_non_contiguous_input():
    dev = _cuda()
    rng = np.random.default_rng(13)
    w = dense_to_bcsr(_block_sparse(rng, 64, 128, (8, 128), 0.5), (8, 128)).to(dev)
    x = torch.tensor(rng.normal(size=(128, 8)), dtype=torch.float32, device=dev).T
    assert not x.is_contiguous()
    torch.testing.assert_close(ops.spmm(x, w), ref.spmm_fwd_ref(x, w),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.gpu
def test_cuda_wrappers_reject_what_the_kernel_does_not_take():
    dev = _cuda()
    w = dense_to_bcsr(np.ones((64, 128), np.float32), (64, 128)).to(dev)
    with pytest.raises(ValueError, match="power of two"):
        ops.spmm(torch.ones(4, 128, device=dev), w)
    w = dense_to_bcsr(np.ones((16, 128), np.float32), (8, 128))
    with pytest.raises(ValueError, match="lies on"):
        ops.spmm(torch.ones(4, 128, device=dev), w)        # W still on the CPU
    with pytest.raises(TypeError):
        ops.spmm(torch.ones(4, 128, device=dev, dtype=torch.float16), w.to(dev))
