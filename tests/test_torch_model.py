"""Reduced-model logits of repro_torch against repro: the full-sequence
forward, prefill and a decode step agree within 1e-4 (reduced configs run
in f32), for dense and BlockCSR weights carried across (PaletteBCSR in
test_torch_model_palette.py)."""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import pytest
import torch

from repro_torch.models.model_zoo import build
from torch_parity import check_logits_match

CASES = [  # (arch, weights, block)
    ("smollm-360m", "dense", None),
    ("smollm-360m", "bcsr", (8, 128)),
    ("qwen3-0.6b", "bcsr", (8, 64)),           # qk_norm
    ("minitron-8b", "bcsr", (8, 64)),          # layernorm, relu2, untied head
    ("command-r-plus-104b", "bcsr", (8, 64)),  # int8 ring KV cache
]


@pytest.mark.parametrize("arch,weights,block", CASES)
def test_logits_match_jax(arch, weights, block):
    check_logits_match(arch, weights, block)


def test_unported_layer_kinds_raise():
    for arch in ("rwkv6-3b", "recurrentgemma-9b", "olmoe-1b-7b"):
        with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
            build(arch, reduced=True, device="cpu")


def test_cuda_default_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build("smollm-360m", reduced=True)


def test_meta_init_gives_shapes_only():
    tm = build("smollm-360m", device="cpu")
    p = tm.init(device="meta")
    assert p["layers"]["b0_attn"]["attn"]["wq"].shape == (32, 960, 15, 64)
    assert p["layers"]["b0_attn"]["attn"]["wo"].shape == (32, 15, 64, 960)
    assert p["embed"]["embedding"].is_meta
