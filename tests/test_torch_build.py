"""The kernel libraries' names: each hashes the files its build reads.

No CUDA toolkit is needed: only the digests are computed, on a copy of
``csrc`` in a temporary directory.
"""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


@pytest.mark.parametrize("name", _build.SOURCES)
def test_inputs_are_the_source_its_includes_and_the_headers(name):
    got = {p.name for p in _build._inputs(name)}
    headers = {p.name for p in _build.CSRC.glob("*.cuh")}
    assert f"{name}.cu" in got and headers <= got
    others = got - headers - {f"{name}.cu"}
    assert others == ({"bsr_spmm.cu"} if name == "bsr_spmm_experts" else set())


@pytest.mark.parametrize("edited, rebuilt", [
    ("bsr_spmm.cu", {"bsr_spmm", "bsr_spmm_experts"}),
    ("bsr_spmm_experts.cu", {"bsr_spmm_experts"}),
    ("prox_adam.cu", {"prox_adam"}),
    ("tc_ops.cuh", set(_build.SOURCES)),
])
def test_an_edit_renames_only_the_libraries_that_read_it(csrc, edited,
                                                         rebuilt):
    before = {n: _build._digest(n) for n in _build.SOURCES}
    with open(csrc / edited, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build._digest(n) for n in _build.SOURCES}
    assert {n for n in _build.SOURCES if before[n] != after[n]} == rebuilt
