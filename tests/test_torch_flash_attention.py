"""The port's flash attention against ``repro.kernels.flash_attention``.

On the CPU ``repro_torch.kernels.flash_attention.ops.flash_attention`` runs
the kernel's plain version; it is held against the JAX Pallas kernel in
interpret mode over the sweep of ``tests/test_kernels_flash.py`` (four
(b, s, h, kv, hd) shapes causal and not, windows 16 and 32 at bq = bk = 32,
bf16) with its tolerances, and on cases whose top rows start on a fully
masked kv tile. The CUDA kernel itself is checked on the card
(``test_torch_gpu_kernels.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro_torch.kernels.flash_attention import ops, ref

F32_ATOL, F32_RTOL = 2e-5, 1e-4       # test_kernels_flash.py's tolerances
BF16_TOL = 0.05


def _inputs(seed, b, s, h, kv, hd):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd)))


def _both(arrays, dtype=torch.float32, **kw):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jops.flash_attention(*(jnp.asarray(a, jdt) for a in arrays),
                                interpret=True, **kw)
    got = ops.flash_attention(*(torch.tensor(a).to(dtype) for a in arrays),
                              **kw)
    assert got.dtype == dtype and got.shape == arrays[0].shape
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("b,s,h,kv,hd", [
    (2, 64, 4, 2, 32), (1, 128, 4, 1, 16), (2, 64, 4, 4, 32),
    (1, 64, 8, 2, 64),
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas(b, s, h, kv, hd, causal):
    got, want = _both(_inputs(b * 1000 + s + h + hd, b, s, h, kv, hd),
                      causal=causal, bq=16, bk=16)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("window", [16, 32])
def test_plain_sliding_window(window):
    got, want = _both(_inputs(0, 1, 128, 2, 2, 16), causal=True,
                      window=window, bq=32, bk=32)
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)


def test_plain_bf16():
    got, want = _both(_inputs(1, 1, 64, 2, 2, 32), torch.bfloat16, bq=16,
                      bk=16)
    np.testing.assert_allclose(got, want, atol=BF16_TOL, rtol=BF16_TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_fully_masked_first_tile(causal):
    """Window 8 at bq = bk = 64 with GQA: in the second q tile every row
    from 72 on sees no key of the first kv tile, which the TPU kernel runs
    first, so those rows accumulate exp(0) terms of the -1e30 sentinel
    until the diagonal tile wipes them; the output is the masked softmax
    all the same (no NaN, no junk)."""
    arrays = _inputs(3, 1, 128, 4, 2, 32)
    got, want = _both(arrays, causal=causal, window=8, bq=64, bk=64)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=F32_RTOL)
    b, s, h, hd = arrays[0].shape
    plain = ref.flash_attention_ref(
        torch.tensor(arrays[0]).transpose(1, 2).reshape(b * h, s, hd),
        torch.tensor(arrays[1]).transpose(1, 2).reshape(b * 2, s, hd),
        torch.tensor(arrays[2]).transpose(1, 2).reshape(b * 2, s, hd),
        causal=causal, window=8)
    np.testing.assert_allclose(
        plain.reshape(b, h, s, hd).transpose(1, 2).numpy(), want,
        atol=F32_ATOL, rtol=F32_RTOL)


def test_wrapper_checks_the_tiling_and_the_device():
    q, k, v = (torch.tensor(a) for a in _inputs(4, 1, 48, 2, 1, 16))
    with pytest.raises(ValueError, match="multiple of bq"):
        ops.flash_attention(q, k, v, bq=32, bk=32)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ops.flash_attention_fwd(*(t.to("meta").transpose(1, 2).reshape(-1, 48, 16)
                                  for t in (q, k, v)), bq=16, bk=16)
    assert ops.launches["flash_attention_fwd"] == 0   # the CPU never launches
