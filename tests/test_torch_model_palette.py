"""Reduced smollm-360m logits of repro_torch against repro with
PaletteBCSR weights (8 and 4 bits) carried across: within 1e-4."""
import jax  # noqa: F401  (both packages in one process, JAX on the CPU)
import pytest
import torch  # noqa: F401

from torch_parity import check_logits_match


@pytest.mark.parametrize("weights,block", [("pal8", (8, 128)), ("pal4", (8, 64))])
def test_palette_logits_match_jax(weights, block):
    check_logits_match("smollm-360m", weights, block)
