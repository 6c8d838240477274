"""The recurrent families (rwkv6-3b, recurrentgemma-9b) end to end on the
CPU: the bridge carries their ``rec`` / ``tm`` / ``cm`` subtrees across,
dense and compressed; a compressed JAX checkpoint of them is served by the
port with the JAX package's greedy tokens; and the port's serve CLI runs
them with and without ``--engine``, ``--sparse`` and ``--quantize-bits``.
Their training is held in ``test_torch_rglru_train.py`` and
``test_torch_rwkv_train.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.models.model_zoo import build as jax_build
from repro.serve import step as jstep
from repro.sparse.compress import iter_bcsr as jax_iter_bcsr
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core.metrics import tree_leaves
from repro_torch.launch import serve
from repro_torch.models.model_zoo import build
from repro_torch.serve import step
from repro_torch.sparse.compress import CompressedParams, iter_bcsr
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR
from torch_parity import format_fields, jax_reduced_params, to_port

ARCHS = ["rwkv6-3b", "recurrentgemma-9b"]
SUBTREES = {"rwkv6-3b": ("tm", "cm"), "recurrentgemma-9b": ("rec",)}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("weights", ["dense", "bcsr", "pal4"])
def test_bridge_carries_recurrent_subtrees(arch, weights):
    """Every leaf arrives unchanged, in the same nesting; compressed
    recurrent projections arrive as the same format with equal fields."""
    jm = jax_build(arch, reduced=True)
    jp = jax_reduced_params(jm, weights, (8, 64), seed=2)
    tp = to_port(jp)
    jdense = jp if weights == "dense" else jp.dense
    tdense = tp if weights == "dense" else tp.dense
    want = dict(_flat(jax.tree.map(np.asarray, jdense)))
    got = dict(_flat(tdense))
    assert got.keys() == want.keys()
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path].numpy(), leaf, err_msg=path)
    assert any(f"/{sub}/" in path for path in got for sub in SUBTREES[arch])
    if weights == "dense":
        return
    assert isinstance(tp, CompressedParams)
    jleaves = dict(jax_iter_bcsr(jp))
    tleaves = dict(iter_bcsr(tp))
    assert tleaves.keys() == jleaves.keys()
    assert any(f"/{sub}/" in path for path in tleaves for sub in SUBTREES[arch])
    kind = PaletteBCSR if weights == "pal4" else BlockCSR
    for path, m in tleaves.items():
        assert isinstance(m, kind), path
        for name, value in format_fields(jleaves[path]).items():
            got_v = getattr(m, name)
            if isinstance(got_v, torch.Tensor):
                np.testing.assert_array_equal(got_v.numpy(), value, err_msg=path)
            else:
                assert tuple(np.atleast_1d(got_v)) == tuple(np.atleast_1d(value))


@pytest.mark.parametrize("arch", ARCHS)
def test_restore_jax_checkpoint_generates_same_tokens(tmp_path, arch):
    jm = jax_build(arch, reduced=True)
    cp = jax_reduced_params(jm, "bcsr", (8, 64), seed=6, sparsity=0.6)
    JaxCheckpointer(str(tmp_path)).save(
        3, cp, extra={"plan": dataclasses.asdict(cp.plan), "arch": arch,
                      "reduced": True})
    tp = Checkpointer(str(tmp_path)).restore_compressed(device="cpu")
    assert any(f"/{sub}/" in path for path, _ in iter_bcsr(tp)
               for sub in SUBTREES[arch])
    prompt = np.random.default_rng(7).integers(0, 128, size=(2, 5)).astype(np.int32)
    want = np.asarray(jstep.generate(
        jm, JaxCheckpointer(str(tmp_path)).restore_compressed(),
        jnp.asarray(prompt), 8))
    got = step.generate(build(arch, reduced=True, device="cpu"), tp,
                        torch.tensor(prompt), 8)
    np.testing.assert_array_equal(got.numpy(), want)


BASE = ["--reduced", "--batch", "2", "--prompt-len", "4", "--gen", "3",
        "--device", "cpu"]
ENGINE = ["--engine", "--device", "cpu", "--reduced", "--max-batch", "3",
          "--prefill-chunk", "8", "--page-size", "4", "--batch", "4",
          "--prompt-len", "11", "--gen", "4", "--parity-check"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("extra", [[], ["--sparse"],
                                   ["--sparse", "--quantize-bits", "8"]])
def test_cli_generate(arch, extra, capsys):
    out = serve.main(BASE + ["--arch", arch] + extra)
    assert out.shape == (2, 3) and out.dtype == torch.int32
    printed = capsys.readouterr().out
    if extra:
        assert "model size dense=" in printed
        assert ("pal8" in printed) == ("--quantize-bits" in extra)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("extra", [[], ["--sparse"],
                                   ["--sparse", "--quantize-bits", "4"]])
def test_cli_engine_parity(arch, extra, capsys):
    """Four requests of 11 prompt tokens (chunked at 8) over three slots:
    the engine's greedy tokens equal generate's (``--parity-check``)."""
    out = serve.main(ENGINE + ["--arch", arch] + extra)
    printed = capsys.readouterr().out
    assert "engine-vs-generate parity OK (4 requests)" in printed
    s = out["stats"]
    assert s["n_requests"] == 4 and s["n_generated"] == 16
    assert s["state_slot_bytes"] > 0
    assert (s["kv_page_bytes"] == 0) == (arch == "rwkv6-3b")
    assert "recurrent_state=" in printed


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_engine_refuses_prefix_cache(arch):
    with pytest.raises(NotImplementedError, match="not position-sliceable"):
        serve.main(ENGINE + ["--arch", arch, "--prefix-cache"])


def test_recurrent_caches_are_state_sized():
    """``init_cache`` of the pure-RWKV model holds no attention ring: its
    bytes do not grow with the sequence length."""
    tm = build("rwkv6-3b", reduced=True, device="cpu")
    short = sum(t.numel() for t in tree_leaves(tm.init_cache(2, 8)))
    long = sum(t.numel() for t in tree_leaves(tm.init_cache(2, 4096)))
    assert short == long > 0
