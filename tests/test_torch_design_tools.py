"""The design tools' variants (``tools/expert_spmm_design.py``,
``tools/expert_bwd_design.py``) still apply to the shipped CUDA sources:
every patch of every variant finds its text the number of times it
expects, and changes the source. Nothing is built or run."""
import importlib
import sys
from pathlib import Path

import pytest

TOOLS = Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))

cuda_variants = importlib.import_module("cuda_variants")
from repro_torch.kernels import _build  # noqa: E402

_TOOLS = {"expert_spmm_design": "bsr_spmm_experts",
          "expert_bwd_design": "bsr_experts_bwd"}


def _variants():
    for tool, source in _TOOLS.items():
        for name in importlib.import_module(tool).VARIANTS:
            yield tool, source, name


@pytest.mark.parametrize("tool,source,name", list(_variants()))
def test_design_variant_patches_the_shipped_source(tool, source, name):
    variants = importlib.import_module(tool).VARIANTS
    src = (_build.CSRC / f"{source}.cu").read_text()
    assert cuda_variants.patched(variants, name, src) != src


def test_patched_checks_each_replacement_count():
    variants = {"two": [("a", "b", 2)], "one": [("a", "b")],
                "fn": [lambda s: s.upper()]}
    assert cuda_variants.patched(variants, "two", "aa") == "bb"
    assert cuda_variants.patched(variants, "fn", "aa") == "AA"
    with pytest.raises(AssertionError):
        cuda_variants.patched(variants, "one", "aa")
