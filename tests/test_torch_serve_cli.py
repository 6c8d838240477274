"""A compressed checkpoint written by the JAX Checkpointer is served by
repro_torch with the same greedy tokens; the port's serve CLI runs its
prune, quantize and checkpoint paths on the CPU, and its continuous-
batching engine path with the parity check and telemetry, whose counters
equal the JAX CLI's for the same request mix."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.launch import serve as jax_serve
from repro.models.model_zoo import build as jax_build
from repro.serve import step as jstep
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build
from repro_torch.obs.metrics import parse_prometheus
from repro_torch.obs.trace import validate_chrome_trace
from repro_torch.serve import step
from repro_torch.sparse.compress import iter_bcsr
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR
from torch_parity import jax_reduced_params

ARCH = "smollm-360m"


def _save(tmp_path, weights, block):
    jm = jax_build(ARCH, reduced=True)
    cp = jax_reduced_params(jm, weights, block, seed=6, sparsity=0.6)
    JaxCheckpointer(str(tmp_path)).save(
        7, cp, extra={"plan": dataclasses.asdict(cp.plan), "arch": ARCH,
                      "reduced": True})
    return jm, cp


@pytest.mark.parametrize("weights,block", [("bcsr", (8, 64)), ("pal4", (8, 128))])
def test_restore_jax_checkpoint_generates_same_tokens(tmp_path, weights, block):
    jm, _ = _save(tmp_path, weights, block)
    ckpt = Checkpointer(str(tmp_path))
    assert ckpt.latest_step() == 7 and ckpt.manifest(7)["extra"]["arch"] == ARCH
    tp = ckpt.restore_compressed(device="cpu")
    kind = PaletteBCSR if weights.startswith("pal") else BlockCSR
    assert tp.plan.block == block
    leaves = [m for _, m in iter_bcsr(tp)]
    assert leaves and all(isinstance(m, kind) for m in leaves)
    jp = JaxCheckpointer(str(tmp_path)).restore_compressed()
    prompt = np.random.default_rng(7).integers(0, 128, size=(2, 5)).astype(np.int32)
    want = np.asarray(jstep.generate(jm, jp, jnp.asarray(prompt), 8))
    got = step.generate(build(ARCH, reduced=True, device="cpu"), tp,
                        torch.tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


def test_restore_rejects_non_compressed_checkpoint(tmp_path):
    JaxCheckpointer(str(tmp_path)).save(1, {"w": np.ones((2, 2), np.float32)})
    with pytest.raises(ValueError, match="not a CompressedParams"):
        Checkpointer(str(tmp_path)).restore_compressed(device="cpu")


BASE = ["--reduced", "--batch", "2", "--prompt-len", "4", "--gen", "3",
        "--device", "cpu"]


@pytest.mark.parametrize("extra", [[], ["--sparse"],
                                   ["--sparse", "--quantize-bits", "4"]])
def test_cli_prune_paths(extra, capsys):
    out = serve.main(BASE + extra)
    assert out.shape == (2, 3) and out.dtype == torch.int32
    printed = capsys.readouterr().out
    if extra:
        assert "model size dense=" in printed and "total serving bytes" in printed
        assert ("palette=" in printed) == ("--quantize-bits" in extra)
        assert ("pal4" in printed) == ("--quantize-bits" in extra)


def test_cli_serves_jax_checkpoint(tmp_path, capsys):
    _save(tmp_path / "compressed", "pal8", (8, 64))
    out = serve.main(BASE + ["--ckpt-dir", str(tmp_path)])
    assert out.shape == (2, 3)
    assert "pal8" in capsys.readouterr().out


def test_cli_rejects_what_is_not_ported(tmp_path):
    with pytest.raises(SystemExit, match="none|single|multi|DATA,MODEL"):
        serve.main(BASE + ["--mesh", "2x2"])
    with pytest.raises(SystemExit, match="--replicas with --mesh"):
        serve.main(BASE + ["--engine", "--replicas=2", "--mesh=2,2",
                           "--logits-out=x.npy"])
    with pytest.raises(SystemExit, match="prune path only"):
        serve.main(BASE + ["--quantize-bits", "8"])
    with pytest.raises(SystemExit, match="no checkpoints"):
        serve.main(BASE + ["--ckpt-dir", str(tmp_path)])
    _save(tmp_path, "bcsr", (8, 64))
    with pytest.raises(SystemExit, match="trained with arch"):
        serve.main(BASE + ["--ckpt-dir", str(tmp_path), "--arch", "qwen3-0.6b"])


ENGINE = ["--engine", "--device", "cpu", "--reduced", "--sparse",
          "--max-batch", "3", "--prefill-chunk", "8", "--page-size", "4"]


def _request_file(tmp_path) -> str:
    """Explicit prompts (the two packages seed random prompts differently)
    with mixed lengths, generation budgets and priorities."""
    rng = np.random.default_rng(3)
    spec = [{"prompt": rng.integers(0, 128, n).tolist(), "gen": g,
             "priority": pri}
            for n, g, pri in ((5, 4, "standard"), (13, 3, "batch"),
                              (2, 6, "interactive"), (9, 2, "standard"),
                              (17, 4, "standard"))]
    path = tmp_path / "requests.json"
    path.write_text(json.dumps(spec))
    return str(path)


@pytest.mark.parametrize("extra", [[], ["--quantize-bits", "8"]])
def test_cli_engine_parity_and_telemetry(tmp_path, extra, capsys):
    m_out, t_out = tmp_path / "m.json", tmp_path / "t.json"
    out = serve.main(ENGINE + extra + [
        "--requests", _request_file(tmp_path), "--parity-check",
        "--metrics-out", str(m_out), "--trace-out", str(t_out)])
    printed = capsys.readouterr().out
    assert "engine-vs-generate parity OK (5 requests)" in printed
    assert ("pal8" in printed) == bool(extra)
    s = out["stats"]
    assert s["n_requests"] == 5 and s["n_generated"] == 4 + 3 + 6 + 2 + 4
    metrics = json.loads(m_out.read_text())
    ticks = metrics["repro_engine_ticks_total"]["series"]
    assert sum(x["value"] for x in ticks) == s["n_ticks"]
    events = validate_chrome_trace(json.loads(t_out.read_text()))
    assert sum(e["name"] == "tick" for e in events) == s["n_ticks"]
    assert sum(e["name"] == "done" for e in events) == 5


def test_cli_engine_counters_match_jax(tmp_path):
    """The same request mix through both CLIs: every counter and gauge of
    the Prometheus exposition is equal (the weights differ, but without
    an EOS nothing the counters see depends on them)."""
    reqs = _request_file(tmp_path)
    parsed = []
    for main, name in ((serve.main, "torch"), (jax_serve.main, "jax")):
        path = tmp_path / f"{name}.prom"
        args = ENGINE + ["--requests", reqs, "--metrics-out", str(path)]
        if name == "jax":
            args.remove("--device")
            args.remove("cpu")
        main(args)
        text = path.read_text()
        kinds = {line.split()[2]: line.split()[3] for line in text.splitlines()
                 if line.startswith("# TYPE")}
        parsed.append({k: v for k, v in parse_prometheus(text).items()
                       if kinds.get(k[0]) in ("counter", "gauge")})
    got, want = parsed
    assert len(got) > 10 and got == want


@pytest.mark.parametrize("route,metrics", [("prefix", "m.json"),
                                           ("least-loaded", "m.prom")])
def test_cli_router_serves_with_parity(tmp_path, route, metrics, capsys):
    """--replicas 2: the mix through two engine replicas behind the router,
    every request's tokens equal to generate's; the fleet's metrics carry
    the router's registry and each replica's."""
    m_out, t_out = tmp_path / metrics, tmp_path / "t.json"
    out = serve.main(ENGINE + [
        "--requests", _request_file(tmp_path), "--replicas", "2",
        "--route", route, "--prefix-cache", "--parity-check", "--profile",
        "--metrics-out", str(m_out), "--trace-out", str(t_out)])
    printed = capsys.readouterr().out
    assert f"router[2x {route}]: 5 requests" in printed
    assert "engine-vs-generate parity OK (5 requests)" in printed
    assert printed.count("  replica ") == 2 and "[FAILED]" not in printed
    assert "engine/tick_step" in printed
    s = out["stats"]
    assert s["n_replicas"] == 2 and s["n_failed_replicas"] == 0
    assert sum(r["n_requests"] for r in s["per_replica"]) == 5
    ticks = sum(r["n_ticks"] for r in s["per_replica"])
    if metrics.endswith(".json"):
        fleet = json.loads(m_out.read_text())
        assert fleet["router"]["repro_router_requests_total"]["series"][0][
            "value"] == 5
        assert sum(x["value"] for rep in fleet["replicas"] for x in
                   rep["repro_engine_ticks_total"]["series"]) == ticks
    else:
        parsed = parse_prometheus(m_out.read_text())
        assert sum(v for k, v in parsed.items()
                   if k[0] == "repro_engine_ticks_total") == ticks
        assert {dict(k[1]).get("replica") for k in parsed
                if k[0] == "repro_engine_ticks_total"} == {"0", "1"}
    events = validate_chrome_trace(json.loads(t_out.read_text()))
    assert sum(e["name"] == "done" for e in events) == 5
