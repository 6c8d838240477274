"""The port's training CLI on the CPU (reduced smollm-360m): it runs
SpC-Retrain and prints the JAX CLI's report; its compressed checkpoint is
read by the JAX ``Checkpointer`` and served by both packages'
``launch/serve --sparse --ckpt-dir``; a TrainState checkpoint written by
the JAX loop resumes in the port's loop and one written by the port
restores in JAX's; ``--quantize-bits 4`` and the dense SpC pipeline run."""
import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.core import optimizers as jopt
from repro.data import synthetic as jdata
from repro.launch import serve as jax_serve
from repro.launch import train as jax_train
from repro.models.model_zoo import build as jax_build
from repro.sparse.compress import iter_bcsr as jiter
from repro.train import loop as jloop
from repro.train import step as jstep
from repro.train.state import TrainState as JState
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import optimizers
from repro_torch.data import synthetic as tdata
from repro_torch.launch import serve, train
from repro_torch.models.model_zoo import build
from repro_torch.sparse.compress import iter_bcsr
from repro_torch.sparse.formats import PaletteBCSR
from repro_torch.train import loop as tloop
from repro_torch.train import step as tstep
from repro_torch.train.state import TrainState
from torch_parity import to_port

ARCH = "smollm-360m"
FLAGS = ["--arch", ARCH, "--reduced", "--sparse", "--steps", "20",
         "--debias-steps", "3", "--batch", "2", "--seq", "16", "--lr", "3e-3",
         "--compress", "group_l1:60", "--block", "8", "64", "--log-every", "4"]


def _report_lines(out: str) -> list[str]:
    """The report's line kinds, numbers removed."""
    keep = ("arch=", "loss:", "model size", "compressed checkpoint:",
            "telemetry:", "dense residue", "total serving bytes")
    return [re.sub(r"[0-9.,]+", "#", l.split("/")[0]) for l in out.splitlines()
            if l.startswith(keep)]


def test_sparse_cli_report_matches_jax(tmp_path, capsys):
    tdir, jdir = tmp_path / "t", tmp_path / "j"
    cp, hs, hd, rep = train.main(FLAGS + ["--device", "cpu", "--ckpt-dir",
                                          str(tdir), "--telemetry-out",
                                          str(tmp_path / "t.jsonl")])
    tout = capsys.readouterr().out
    _, jhs, jhd, jrep = jax_train.main(FLAGS + ["--ckpt-dir", str(jdir),
                                                "--telemetry-out",
                                                str(tmp_path / "j.jsonl")])
    jout = capsys.readouterr().out
    assert rep.keys() == jrep.keys()
    assert rep["spc"].keys() == jrep["spc"].keys()
    assert [h.keys() for h in hs] == [h.keys() for h in jhs]
    assert len(hd) == len(jhd) == 2
    assert _report_lines(tout) == _report_lines(jout)
    trecs = [json.loads(l) for l in open(tmp_path / "t.jsonl")]
    jrecs = [json.loads(l) for l in open(tmp_path / "j.jsonl")]
    assert [(r["phase"], sorted(r)) for r in trecs] == \
        [(r["phase"], sorted(r)) for r in jrecs]
    assert list(iter_bcsr(cp)), "nothing was compressed"
    assert all(np.isfinite(h["loss"]) for h in hs + hd)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("spc")
    cp, *_ = train.main(FLAGS + ["--device", "cpu", "--ckpt-dir", str(d)])
    return d, cp


def test_jax_reads_port_compressed_checkpoint(trained, capsys):
    d, cp = trained
    cdir = os.path.join(d, "compressed")
    jcp = JaxCheckpointer(cdir).restore_compressed()
    tl = dict(iter_bcsr(cp))
    jl = dict(jiter(jcp))
    assert tl.keys() == jl.keys()
    for path in tl:
        np.testing.assert_array_equal(tl[path].data.numpy(),
                                      np.asarray(jl[path].data))
        np.testing.assert_array_equal(tl[path].gather_t_blk.numpy(),
                                      np.asarray(jl[path].gather_t_blk))
    assert jcp.plan.block == (8, 64)
    emb = np.asarray(jcp.dense["embed"]["embedding"])
    np.testing.assert_array_equal(emb, cp.dense["embed"]["embedding"].numpy())
    # and the port reads it back bit for bit
    back = Checkpointer(cdir).restore_compressed(device="cpu")
    for path, m in iter_bcsr(back):
        assert torch.equal(m.data, tl[path].data)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_serve_cli_serves_port_checkpoint(trained, capsys, pkg):
    d, _ = trained
    args = ["--arch", ARCH, "--reduced", "--sparse", "--ckpt-dir", str(d),
            "--batch", "2", "--prompt-len", "4", "--gen", "3"]
    if pkg == "port":
        serve.main(args + ["--device", "cpu"])
    else:
        jax_serve.main(args)
    out = capsys.readouterr().out
    assert "model size dense=" in out and "generated (2, 3)" in out


def test_quantize_bits_4(tmp_path, capsys):
    cp, *_ = train.main(FLAGS + ["--device", "cpu", "--quantize-bits", "4",
                                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "palette=" in out
    leaves = [m for _, m in iter_bcsr(cp)]
    assert leaves and all(isinstance(m, PaletteBCSR) and m.bits == 4
                          for m in leaves)
    jcp = JaxCheckpointer(os.path.join(tmp_path, "compressed")) \
        .restore_compressed()
    assert all(m.bits == 4 for _, m in jiter(jcp))


def test_dense_spc_cli_runs(tmp_path, capsys):
    state, hs, hd, rep = train.main(
        ["--arch", ARCH, "--reduced", "--steps", "4", "--debias-steps", "2",
         "--batch", "2", "--seq", "16", "--compress", "l1:1.0",
         "--log-every", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "layer-wise compression:" in out and "debias" in rep
    assert rep["debias"]["nnz"] <= rep["spc"]["nnz"]


def test_cli_rejects_mesh_and_defaults_to_cuda():
    """--mesh takes none | single | multi | DATA,MODEL; a global batch the
    data axis does not split, or a mesh the world cannot fill, exits with
    a message (tests/test_torch_mesh.py trains on a 2,2 mesh)."""
    with pytest.raises(SystemExit, match="none|single|multi|DATA,MODEL"):
        train.main(["--mesh", "2x2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="does not split over the 2 data"):
        train.main(["--mesh", "2,2", "--batch", "3", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="needs 256 devices"):
        train.main(["--mesh", "single", "--device", "cpu"])
    assert train._parser().parse_args([]).device == "cuda"
    assert train._parser().parse_args([]).mesh == "none"


def test_jax_train_state_resumes_in_port(tmp_path):
    """The JAX loop writes a TrainState at step 3; the port's loop resumes
    there and runs on to 5 steps, equal to the JAX loop run on to 5."""
    jm, tm = jax_build(ARCH, reduced=True), build(ARCH, reduced=True,
                                                  device="cpu")
    jcfg = jdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=16,
                                   global_batch=2)
    tcfg = tdata.TokenStreamConfig(vocab=jm.cfg.vocab, seq_len=16,
                                   global_batch=2)
    jo, to = jopt.prox_adam(1e-3, lam=0.1), optimizers.prox_adam(1e-3, lam=0.1)
    jp = jm.init(jax.random.PRNGKey(5))
    jfn = jax.jit(jstep.make_train_step(jm, jo))
    ck = JaxCheckpointer(str(tmp_path / "ck"))
    js, _ = jloop.train_loop(jfn, JState.create(jp, jo),
                             lambda s: jdata.token_batch(jcfg, s),
                             jloop.LoopConfig(total_steps=3), ck)
    js5, jh = jloop.train_loop(jfn, js, lambda s: jdata.token_batch(jcfg, s),
                               jloop.LoopConfig(total_steps=5, log_every=1))
    # the port starts from a fresh init and picks up the JAX checkpoint
    ts0 = TrainState.create(to_port(jm.init(jax.random.PRNGKey(9))), to)
    ts, th = tloop.train_loop(tstep.make_train_step(tm, to), ts0,
                              lambda s: tdata.token_batch(tcfg, s),
                              tloop.LoopConfig(total_steps=5, log_every=1),
                              Checkpointer(str(tmp_path / "ck")))
    assert ts.step == 5 and ts.opt_state.step == 5
    assert [h["step"] for h in th] == [3, 4]
    for a, b in zip(th, jh[-2:]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-4)
    np.testing.assert_allclose(ts.params["embed"]["embedding"].numpy(),
                               np.asarray(js5.params["embed"]["embedding"]),
                               atol=2e-5)
    # the port saved step 5 on exit; the JAX Checkpointer restores it
    assert Checkpointer(str(tmp_path / "ck")).latest_step() == 5
    back = JaxCheckpointer(str(tmp_path / "ck")).restore(5, js5)
    assert int(back.step) == 5 and int(back.opt_state.step) == 5
    np.testing.assert_array_equal(np.asarray(back.opt_state.v["embed"]
                                             ["embedding"]),
                                  ts.opt_state.v["embed"]["embedding"].numpy())
