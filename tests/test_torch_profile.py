"""The serving half of the port's profiler (``repro_torch.obs.profile``):
every kernel entry routes through ``kernel_call`` under the reference's
names, the engine tick is timed as ``engine/tick_step``, ``launch/serve
--profile`` prints the summary, and with no profiler active the hook
calls straight through and never touches the device's timing or
synchronisation.

On the CPU the wrappers run their kernels' plain versions and launch
nothing (the launch counters stay 0), so here each name's count is held
to the calls its entry received and to the count the model's structure
gives (the spmm launches ``chip_smoke.py`` expects on the card); the
GPU-marked test holds the counts to the launch counters themselves.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.bsr_spmm import ops as kops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build
from repro_torch.obs import profile
from repro_torch.serve.step import generate
from repro_torch.sparse.compress import CompressionPlan, init_compressed

ARCH = "olmoe-1b-7b"
GEN = 3


def _olmoe(device="cpu", backend="cuda"):
    """Reduced olmoe with every projection compressed, the kernel wrappers
    as its sparse backend (their plain versions on CPU tensors)."""
    model = build(ARCH, reduced=True, device=device, sparse_backend=backend)
    cp = init_compressed(model, CompressionPlan(block=(8, 64)), 0.5,
                         torch.Generator(device=device).manual_seed(0))
    return model, cp


def _per_forward(model):
    """spmm wrapper calls of one forward: 4 attention projections and 3
    expert launches per layer, and the head."""
    n = model.cfg.n_layers
    return {"bsr_spmm/spmm": 4 * n + 1, "bsr_spmm/spmm_experts": 3 * n}


def test_profile_counts_every_kernel_entry():
    model, cp = _olmoe()
    calls = {"bsr_spmm/spmm": 0, "bsr_spmm/spmm_experts": 0}
    inner = kops._spmm

    def spy(x, w, experts, *rows):
        calls["bsr_spmm/spmm_experts" if experts else "bsr_spmm/spmm"] += 1
        return inner(x, w, experts, *rows)

    prompt = torch.tensor(np.random.default_rng(0).integers(
        0, model.cfg.vocab, (2, 5)))
    kops._spmm = spy
    try:
        with profile.Profiler() as prof:
            assert profile.active() is prof
            generate(model, cp, prompt, GEN)
    finally:
        kops._spmm = inner
    assert profile.active() is None
    summary = prof.summary()
    want = {k: v * GEN for k, v in _per_forward(model).items()}
    assert calls == want
    for name, n in want.items():
        r = summary[name]
        assert r["n_calls"] == n and r["n_traced"] == 0
        assert r["total_ms"] > 0 and r["max_ms"] <= r["total_ms"]
        assert r["mean_ms"] == pytest.approx(r["total_ms"] / n)
    assert not any(kops.launches.values())          # nothing launched here
    text = prof.format_summary()
    assert "bsr_spmm/spmm_experts" in text and f"{want['bsr_spmm/spmm']} calls" in text


def test_cli_profile_engine_summary(capsys):
    """``launch/serve --engine --profile``: one ``engine/tick_step`` per
    tick and one paged attention call per attention layer and tick."""
    out = serve.main(["--arch", ARCH, "--reduced", "--sparse", "--engine",
                      "--device", "cpu", "--attn-backend", "cuda",
                      "--block", "8", "64", "--batch", "3", "--prompt-len",
                      "5", "--gen", "3", "--profile"])
    printed = capsys.readouterr().out
    ticks = out["stats"]["n_ticks"]
    layers = build(ARCH, reduced=True, device="cpu").cfg.n_layers
    lines = {ln.split()[0]: int(ln.split()[1]) for ln in printed.splitlines()
             if ln.startswith("  ") and " calls " in ln}
    assert lines["engine/tick_step"] == ticks
    assert lines["paged_attention/paged_flash_attention"] == layers * ticks


def test_cli_profile_writes_a_torch_profiler_trace(tmp_path, capsys):
    serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                "1", "--prompt-len", "3", "--gen", "2", "--profile",
                str(tmp_path / "trace")])
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    assert "profile (" in capsys.readouterr().out


def test_no_active_profiler_never_synchronises(monkeypatch):
    """With no profiler active the hook is a plain call: no CUDA event is
    made and nothing waits for the device."""
    def forbidden(*a, **k):
        raise AssertionError("the inactive profiler touched the device")

    monkeypatch.setattr(torch.cuda, "synchronize", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    assert profile.active() is None
    assert profile.kernel_call("x/y", lambda a, b=1: a + b, 2, b=3) == 5
    model, cp = _olmoe()
    prompt = torch.zeros(1, 4, dtype=torch.long)
    generate(model, cp, prompt, 2)


@pytest.mark.gpu
def test_cuda_profile_counts_equal_launch_counters():
    """On the card: each kernel entry's count in the summary equals its
    launch counter over the same generate."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    model, cp = _olmoe("cuda", "auto")
    prompt = torch.zeros(2, 5, dtype=torch.long, device="cuda")
    kops.reset_launches()
    paged_ops.reset_launches()
    with profile.Profiler() as prof:
        generate(model, cp, prompt, GEN)
    summary = prof.summary()
    for name, n in _per_forward(model).items():
        key = name.split("/")[1]
        assert kops.launches[key] == n * GEN
        assert summary[name]["n_calls"] == kops.launches[key]
    assert all(r["total_ms"] > 0 for r in summary.values())
