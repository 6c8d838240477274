"""The port's frontend stand-ins (``repro_torch.models.frontends``) and the
input shapes of every (arch x shape) cell against the JAX package's, and
``launch/train`` on the frontend architectures (paligemma-3b: vlm,
musicgen-medium: audio), which train on synthetic (B, S, d) embeddings in
place of token ids. Their logits from embeddings are held to the JAX
package's in ``tests/test_torch_model.py`` (within 1e-4, f32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs.base import SHAPES
from repro.models import frontends as jfrontends
from repro.models import model_zoo as jzoo
from repro_torch.configs import get_config
from repro_torch.launch import train
from repro_torch.models import frontends
from repro_torch.models.model_zoo import build, input_specs

FRONTENDS = ["paligemma-3b", "musicgen-medium"]
_DT = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_input_embedding_spec_matches_jax(arch, dtype):
    want = jfrontends.input_embedding_spec(jax_config(arch), 3, 17, dtype)
    got = frontends.input_embedding_spec(get_config(arch), 3, 17, _DT[dtype])
    assert got.is_meta and tuple(got.shape) == want.shape
    assert got.dtype == _DT[dtype]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", FRONTENDS + ["smollm-360m", "olmoe-1b-7b"])
def test_input_specs_match_jax(arch, shape):
    want = jzoo.input_specs(jax_config(arch), shape)
    got = input_specs(get_config(arch), shape)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].is_meta
        assert str(got[k].dtype).split(".")[-1] == str(want[k].dtype), k


def test_synthetic_embeddings_follow_the_generator():
    cfg = get_config("paligemma-3b").reduced()
    a = frontends.synthetic_embeddings(torch.Generator().manual_seed(3), cfg,
                                       2, 5)
    b = frontends.synthetic_embeddings(torch.Generator().manual_seed(3), cfg,
                                       2, 5)
    c = frontends.synthetic_embeddings(torch.Generator().manual_seed(4), cfg,
                                       2, 5)
    assert a.shape == (2, 5, cfg.d_model) and a.dtype == torch.float32
    assert torch.equal(a, b) and not torch.equal(a, c)
    # 0.02 x a standard normal, as the reference scales them
    big = frontends.synthetic_embeddings(torch.Generator().manual_seed(0),
                                         cfg, 64, 64, torch.bfloat16)
    assert big.dtype == torch.bfloat16
    assert abs(float(big.float().std()) - 0.02) < 1e-3


@pytest.mark.parametrize("arch", FRONTENDS)
def test_model_runs_from_embeddings(arch):
    """apply_train, prefill and decode take (B, S, d) / (B, 1, d) inputs."""
    tm = build(arch, reduced=True, device="cpu")
    params = tm.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    emb = frontends.synthetic_embeddings(gen, tm.cfg, 2, 6)
    logits, aux = tm.apply_train(params, {"inputs": emb})
    assert logits.shape == (2, 6, tm.cfg.vocab)
    lp, cache = tm.prefill(params, emb, tm.init_cache(2, 8))
    torch.testing.assert_close(lp, logits[:, -1], atol=1e-5, rtol=1e-5)
    ld, _ = tm.decode_step(params, frontends.synthetic_embeddings(
        gen, tm.cfg, 2, 1), cache, 6)
    assert ld.shape == (2, 1, tm.cfg.vocab) and bool(torch.isfinite(ld).all())


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_cli_trains_frontend_archs(arch, sparse):
    """``launch/train`` builds the batch as the reference does: synthetic
    embeddings for the inputs, the token stream's labels; the loss falls
    over a few steps."""
    extra = (["--sparse", "--compress", "group_l1:0.01", "--debias-steps",
              "2"] if sparse else ["--compress", "l1:0.01"])
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "6", "--batch", "2", "--seq", "8",
                      "--lr", "3e-3", "--log-every", "1", *extra])
    hist = out[1]
    losses = [h["loss"] for h in hist]
    assert len(losses) >= 6 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
