"""Greedy generation of repro_torch against repro.serve.step.generate,
token for token, for dense, BlockCSR and PaletteBCSR weights; the top-k
and top-p masks against the JAX ones on fixed logits."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.model_zoo import build as jax_build
from repro.serve import step as jstep
from repro_torch.models.model_zoo import build
from repro_torch.serve import step
from repro_torch.serve.api import ApiValidationError, SamplingParams
from repro_torch.serve.kvcache import cache_bytes
from torch_parity import jax_reduced_params, to_port


@pytest.mark.parametrize("weights,block", [
    ("dense", None), ("bcsr", (8, 128)), ("pal8", (8, 64)), ("pal4", (8, 128))])
def test_greedy_generate_matches_jax(weights, block):
    jm = jax_build("smollm-360m", reduced=True)
    tm = build("smollm-360m", reduced=True, device="cpu")
    # 0.6 block sparsity keeps the random model's greedy stream varied, so
    # token parity checks more than one repeated token
    jp = jax_reduced_params(jm, weights, block, seed=3, sparsity=0.6)
    prompt = np.random.default_rng(4).integers(
        0, jm.cfg.vocab, size=(2, 6)).astype(np.int32)
    want = np.asarray(jstep.generate(jm, jp, jnp.asarray(prompt), 10))
    assert len(np.unique(want)) >= 4
    got = step.generate(tm, to_port(jp), torch.tensor(prompt), 10)
    assert got.dtype == torch.int32 and got.shape == (2, 10)
    np.testing.assert_array_equal(got.numpy(), want)


def _logits():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 40)).astype(np.float32)
    logits[0, :4] = logits[0].max() + 1.0        # a tie at the top
    logits[1, 10:13] = 0.5                      # a tie in the middle
    return logits


@pytest.mark.parametrize("k", [1, 3, 12])
def test_top_k_mask_matches_jax(k):
    logits = _logits()
    got = step._top_k_mask(torch.tensor(logits), k)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jstep._top_k_mask(jnp.asarray(logits), k)))


@pytest.mark.parametrize("p", [0.05, 0.5, 0.9, 1.0])
def test_top_p_mask_matches_jax(p):
    logits = _logits()
    got = step._top_p_mask(torch.tensor(logits), p)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jstep._top_p_mask(jnp.asarray(logits), p)))


def test_sampled_tokens_stay_inside_the_masks():
    logits = torch.tensor(_logits())
    gen = torch.Generator().manual_seed(0)
    allowed = torch.isfinite(step._top_p_mask(step._top_k_mask(logits, 5), 0.8))
    for _ in range(20):
        tok = step.sample_token(logits, 0.7, gen, top_k=5, top_p=0.8)
        assert tok.dtype == torch.int32 and tok.shape == (3,)
        assert allowed[torch.arange(3), tok.long()].all()
    greedy = step.make_sampler(SamplingParams())(logits, gen)
    np.testing.assert_array_equal(
        greedy.numpy(), np.asarray(jstep.sample_token(jnp.asarray(logits.numpy()))))


def test_sampling_params_validate():
    with pytest.raises(ApiValidationError):
        SamplingParams(top_p=0.0)
    with pytest.raises(ApiValidationError, match="did you mean"):
        SamplingParams.from_json({"temprature": 0.5})


def test_cache_bytes_matches_jax():
    from repro.serve.kvcache import cache_bytes as jax_cache_bytes, cache_spec
    for arch in ("smollm-360m", "command-r-plus-104b"):
        jm = jax_build(arch, reduced=True)
        tm = build(arch, reduced=True, device="cpu")
        assert cache_bytes(tm.init_cache(3, 20)) == \
            jax_cache_bytes(cache_spec(jm, 3, 20))
