"""A compressed checkpoint written by the JAX Checkpointer is served by
repro_torch with the same greedy tokens; the port's serve CLI runs its
prune, quantize and checkpoint paths on the CPU."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.models.model_zoo import build as jax_build
from repro.serve import step as jstep
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build
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
    with pytest.raises(SystemExit, match="Queue 1 item 7"):
        serve.main(BASE + ["--engine"])
    with pytest.raises(SystemExit, match="Queue 1 item 11"):
        serve.main(BASE + ["--replicas=2"])
    with pytest.raises(SystemExit, match="prune path only"):
        serve.main(BASE + ["--quantize-bits", "8"])
    with pytest.raises(SystemExit, match="no checkpoints"):
        serve.main(BASE + ["--ckpt-dir", str(tmp_path)])
    _save(tmp_path, "bcsr", (8, 64))
    with pytest.raises(SystemExit, match="trained with arch"):
        serve.main(BASE + ["--ckpt-dir", str(tmp_path), "--arch", "qwen3-0.6b"])
