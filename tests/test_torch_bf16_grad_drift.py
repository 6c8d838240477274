"""The port's bf16 training gradients held to the reference's, on the
CPU, for the families whose gradients no other test holds in bf16:
smollm-360m (attention), recurrentgemma-9b (RG-LRU and local attention)
and olmoe-1b-7b (MoE). rwkv6-3b's case is
``test_torch_rwkv_train.py::test_bf16_training_step_runs_and_tracks_jax``.

Each case runs one bf16 loss-and-gradient of the reduced config at
weights the JAX package made, in both packages, with the f32 masters of
rank >= 2 cast to bf16 as the train steps cast them
(``torch_recurrent_train.check_bf16_grad_drift``). The loss agrees within
2^-8 relative; every leaf's bf16 gradient drift from its own package's f32
gradient, over the leaf's largest f32 |g|, is held to the reference's plus
max(a quarter of it, 2^-8). olmoe-1b-7b routes every token to all of its
experts (top-k = E, as ``test_torch_bf16_drift.py`` does): where bf16
moves a router's top-k set a token's gradient jumps to another expert,
and that hides a rounding fault. ``-s`` prints each leaf's two drifts.
"""
import dataclasses

import pytest

from repro.models.model_zoo import build as jax_build
from torch_recurrent_train import check_bf16_grad_drift, pruned


def _all_experts(cfg):
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, top_k=cfg.moe.n_experts))


@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-9b",
                                  "olmoe-1b-7b"])
def test_bf16_gradients_drift_within_the_reference(arch):
    jm = jax_build(_all_experts(jax_build(arch, reduced=True).cfg))
    jp = pruned(jm, seed=3)
    check_bf16_grad_drift(arch, jp, adjust=_all_experts, norm="l2")
