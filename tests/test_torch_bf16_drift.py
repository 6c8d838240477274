"""The port's bf16 model path held to the reference's, on the CPU.

Every other parity test runs a reduced config, and ``reduced()`` sets
``compute_dtype="float32"``: no bf16 path of the port was compared with
the JAX package, though the card runs bf16. Two packages that round at
different places do not give the same bf16 logits, so they are not
compared with each other directly. Instead, for each family, each
package's bf16 drift from its own f32 (max |bf16 - f32| over max |f32|,
the same BCSR weights carried across as numpy through
``repro_torch.checkpoint.bridge``) is computed, and the port's drift is
held to the reference's plus a margin of a quarter of it (at least 0.002
of max |logit|). A bf16-only fault in the port (a missing upcast, an f32
sum kept in bf16) would show as a larger drift.

The configs are the reduced ones widened to d 256 (4 heads of 64, d_ff
512, lru 256), vocab 512, 8 layers (recurrentgemma-9b and olmoe-1b-7b at
their reduced depths of 5 and 2; olmoe keeps its reduced 4 experts of 64,
routed to all 4: see ``_cfg``), BCSR (8, 64) at 0.8 block sparsity, a
(2, 64) prompt, bf16 forced
with ``dataclasses.replace(..., compute_dtype="bfloat16")``.

Greedy tokens: at the positions where the reference's bf16 logits are
clear of its own bf16 drift (top-2 margin above twice the largest
|bf16 - f32| of the reference), the port's bf16 argmax equals the
reference's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models.model_zoo import build as jax_build
from repro_torch.configs import get_config
from repro_torch.models.model_zoo import build
from torch_parity import jax_reduced_params, to_port

WIDE = dict(d_model=256, head_dim=64, d_ff=512, vocab=512)
LAYERS = {"smollm-360m": 8, "recurrentgemma-9b": None, "rwkv6-3b": 8,
          "olmoe-1b-7b": None}
MARGIN_SHARE, MARGIN_FLOOR = 0.25, 0.002
# the two packages in f32 on the same weights (the f32 parity tests' bound
# scaled to these logits)
F32_TOL = 1e-4


def _cfg(cfg, arch, dtype):
    cfg = cfg.reduced()
    wide = dict(WIDE, compute_dtype=dtype)
    if cfg.lru_width:
        wide["lru_width"] = 256
    if LAYERS[arch]:
        wide["n_layers"] = LAYERS[arch]
    if cfg.moe is not None:
        # top-k = E: where bf16 moves a router's top-k set, a token goes to
        # another expert and its logits jump (both packages drift 0.11-0.45
        # of max |logit| from f32 at top-2, and no position is clear of
        # that); routed to every expert, the expert FFN, gates, dispatch
        # and combine run in bf16 with no discontinuity
        wide["moe"] = dataclasses.replace(cfg.moe, top_k=cfg.moe.n_experts)
    return dataclasses.replace(cfg, **wide)


def _drift(bf16, f32) -> float:
    return float(np.abs(bf16 - f32).max() / np.abs(f32).max())


@pytest.mark.parametrize("arch", list(LAYERS))
def test_port_bf16_drift_within_the_reference(arch):
    j32 = jax_build(_cfg(jax_config(arch), arch, "float32"))
    j16 = jax_build(_cfg(jax_config(arch), arch, "bfloat16"))
    t32 = build(_cfg(get_config(arch), arch, "float32"), device="cpu")
    t16 = build(_cfg(get_config(arch), arch, "bfloat16"), device="cpu")
    jp = jax_reduced_params(j32, "bcsr", (8, 64), seed=3)
    tp = to_port(jp)
    prompt = np.random.default_rng(4).integers(0, WIDE["vocab"], (2, 64)) \
        .astype(np.int32)

    def jax_logits(model):
        out, _ = model.apply_train(jp, {"inputs": jnp.asarray(prompt)})
        return np.asarray(out.astype(jnp.float32))

    def port_logits(model):
        with torch.no_grad():
            out, _ = model.apply_train(tp, {"inputs": torch.tensor(prompt)})
        return out.float().numpy()

    jl32, jl16 = jax_logits(j32), jax_logits(j16)
    tl32, tl16 = port_logits(t32), port_logits(t16)
    scale = float(np.abs(jl32).max())
    np.testing.assert_allclose(tl32, jl32, atol=F32_TOL * scale)

    ref_drift, port_drift = _drift(jl16, jl32), _drift(tl16, tl32)
    margin = max(MARGIN_SHARE * ref_drift, MARGIN_FLOOR)
    print(f"{arch}: bf16 drift from f32, share of max |logit|: reference "
          f"{ref_drift:.4f}, port {port_drift:.4f}; port bf16 vs reference "
          f"bf16 {_drift(tl16, jl16):.4f}")
    assert np.isfinite(tl16).all()
    assert port_drift <= ref_drift + margin, (
        f"{arch}: the port's bf16 drifts {port_drift:.4f} of max |logit| "
        f"from its f32, the reference's {ref_drift:.4f} (margin {margin:.4f})")

    top2 = np.sort(jl16, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * ref_drift * scale
    assert clear.sum() >= 8, f"{arch}: only {clear.sum()} clear positions"
    print(f"{arch}: {int(clear.sum())} of {clear.size} positions clear of the "
          "reference's drift; their greedy tokens agree")
    np.testing.assert_array_equal(tl16.argmax(-1)[clear],
                                  jl16.argmax(-1)[clear])
