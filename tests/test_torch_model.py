"""Reduced-model logits of repro_torch against repro: the full-sequence
forward, prefill and a decode step agree within 1e-4 (reduced configs run
in f32), for dense and BlockCSR weights carried across, for the recurrent
families (rwkv6-3b, recurrentgemma-9b) also PaletteBCSR at 8 and 4 bits
(smollm-360m's PaletteBCSR in test_torch_model_palette.py), for the MoE
family with dense, BlockCSR and PaletteBCSR-8 experts, and for the
frontend architectures fed (B, S, d) embeddings."""
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
] + [(arch, weights, block)                    # the recurrent families
     for arch in ("rwkv6-3b", "recurrentgemma-9b")
     for weights, block in (("dense", None), ("bcsr", (8, 64)),
                            ("pal8", (8, 64)), ("pal4", (8, 64)))] + [
    ("olmoe-1b-7b", "dense", None),            # 4 experts, top-2
    ("olmoe-1b-7b", "bcsr", (8, 64)),          # E-stacked expert BCSR
    ("olmoe-1b-7b", "pal8", (8, 64)),          # a palette per expert
    ("llama4-scout-17b-a16e", "dense", None),  # top-1, shared expert
    ("llama4-scout-17b-a16e", "bcsr", (8, 64)),
    ("paligemma-3b", "dense", None),           # (B, S, d) embeddings
    ("paligemma-3b", "bcsr", (8, 64)),
    ("musicgen-medium", "dense", None),
    ("musicgen-medium", "bcsr", (8, 64)),
]


@pytest.mark.parametrize("arch,weights,block", CASES)
def test_logits_match_jax(arch, weights, block):
    check_logits_match(arch, weights, block)


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
