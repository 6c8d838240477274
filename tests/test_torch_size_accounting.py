"""The port's size accounting against the JAX package's: the CSR model
size, Deep-Compression quantization and its byte estimate, elementwise CSR
and BlockCSR density, on the same pruned reduced trees and matrices; the
worked example of ``docs/size_accounting.md``; and CSR leaves the port's
checkpointer writes restored by the JAX package's."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JaxCheckpointer
from repro.core import metrics as jmetrics
from repro.core import quantize as jquantize
from repro.models.model_zoo import build as jax_build
from repro.sparse import formats as jformats
from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.core import metrics, quantize
from repro_torch.sparse import formats
from repro_torch.sparse.compress import quantize_bcsr
from torch_parity import to_port


@pytest.fixture(scope="module")
def pruned():
    """Reduced smollm-360m, magnitude-pruned elementwise at 0.9 with
    numpy, as a JAX tree and as the port's."""
    params = jax_build("smollm-360m", reduced=True).init(jax.random.PRNGKey(4))

    def prune(a):
        a = np.array(a)
        if a.ndim >= 2:
            a[np.abs(a) < np.quantile(np.abs(a), 0.9)] = 0.0
        return a

    jp = jax.tree.map(prune, params)
    return jax.tree.map(jnp.asarray, jp), to_port(jp)


@pytest.mark.parametrize("index_bytes", [2, 4])
@pytest.mark.parametrize("sparse", [False, True])
def test_model_size_bytes(pruned, sparse, index_bytes):
    jp, tp = pruned
    got = metrics.model_size_bytes(tp, sparse=sparse, index_bytes=index_bytes)
    assert got == jmetrics.model_size_bytes(jp, sparse=sparse,
                                            index_bytes=index_bytes)
    if sparse:
        assert got < metrics.model_size_bytes(tp)


def test_model_size_bytes_reads_no_value_dense():
    meta = {"w": torch.empty(64, 32, device="meta"),
            "b": torch.empty(32, device="meta", dtype=torch.bfloat16)}
    assert metrics.model_size_bytes(meta) == 64 * 32 * 4 + 32 * 2


@pytest.mark.parametrize("bits", [2, 4])
def test_quantize_tree_and_size(pruned, bits):
    jp, tp = pruned
    jq, jrep = jquantize.quantize_tree(jp, bits=bits)
    tq, trep = quantize.quantize_tree(tp, bits=bits)
    assert list(trep) == list(jrep) and trep
    for name, r in trep.items():
        assert r["bits"] == bits
        assert r["rel_err"] == pytest.approx(jrep[name]["rel_err"], abs=1e-6)
        assert r["huffman_bits"] == jrep[name]["huffman_bits"], name
    for (path, jleaf), tleaf in zip(jax.tree_util.tree_leaves_with_path(jq),
                                    metrics.tree_leaves(tq)):
        np.testing.assert_allclose(tleaf.numpy(), np.asarray(jleaf),
                                   atol=1e-6, err_msg=str(path))
    for reports in (None, "reports"):
        want = jquantize.quantized_size_bytes(
            jq, bits=bits, reports=jrep if reports else None)
        got = quantize.quantized_size_bytes(
            tq, bits=bits, reports=trep if reports else None)
        assert got == want
    assert got < metrics.model_size_bytes(tq, sparse=True) \
        < metrics.model_size_bytes(tq)


@pytest.mark.parametrize("seed", range(3))
def test_huffman_bits_estimate(seed):
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, 16, 500).astype(np.int32)
    nz = rng.random(500) < 0.4
    assert quantize.huffman_bits_estimate(assign, nz) == \
        jquantize.huffman_bits_estimate(assign, nz)
    assert quantize.huffman_bits_estimate(assign, np.zeros(500, bool)) == 0.0


@pytest.mark.parametrize("shape,density", [((37, 53), 0.2), ((8, 8), 0.0),
                                           ((64, 128), 0.7)])
def test_csr_roundtrip_matches_reference(shape, density):
    rng = np.random.default_rng(shape[0])
    w = rng.normal(size=shape).astype(np.float32)
    w[rng.random(shape) >= density] = 0.0
    m = formats.dense_to_csr(torch.from_numpy(w))
    jm = jformats.dense_to_csr(w)
    for f in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(getattr(m, f).numpy(),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert m.indices.dtype == m.indptr.dtype == torch.int32
    assert (m.shape, m.nnz, m.nbytes) == (jm.shape, jm.nnz, jm.nbytes)
    np.testing.assert_array_equal(formats.csr_to_dense(m).numpy(), w)
    np.testing.assert_array_equal(np.asarray(jformats.csr_to_dense(jm)), w)


@pytest.mark.parametrize("block,density", [((8, 64), 0.3), ((4, 16), 0.05),
                                           ((16, 32), 1.0)])
def test_bcsr_density_matches_reference(block, density):
    rng = np.random.default_rng(block[1])
    w = rng.normal(size=(64, 96)).astype(np.float32)
    br, bc = block
    keep = rng.random((-(-64 // br), -(-96 // bc))) < density
    w *= np.kron(keep, np.ones(block))[:64, :96]
    got = formats.bcsr_density(formats.dense_to_bcsr(w, block))
    assert got == jformats.bcsr_density(jformats.dense_to_bcsr(w, block))


def test_docs_worked_example():
    """docs/size_accounting.md: (256, 512) f32, (8, 64) blocks, 64 of 256
    resident: 524,288 dense, 133,512 BCSR, 34,696 palette-8, 17,096
    palette-4 bytes."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(256, 512)).astype(np.float32)
    occ = (np.arange(32 * 8).reshape(32, 8) % 4) == 0
    w *= np.kron(occ, np.ones((8, 64)))
    assert metrics.model_size_bytes({"w": torch.from_numpy(w)}) == 524_288
    m = formats.dense_to_bcsr(w, block=(8, 64))
    assert (m.n_blocks, m.nbytes) == (64, 133_512)
    q8, q4 = quantize_bcsr(m, 8), quantize_bcsr(m, 4)
    assert q8.nbytes == 34_696 and q8.bcsr_equiv_nbytes == m.nbytes
    assert q4.nbytes == 17_096
    assert formats.bcsr_density(m) == 0.25


def test_port_csr_checkpoint_restores_in_jax(tmp_path, pruned):
    """A dense tree whose pruned matrices the port's checkpointer stores as
    CSR leaves; the JAX package's restores it exactly."""
    jp, tp = pruned
    tree = {"layers": tp["layers"], "embed": tp["embed"],
            "small": torch.zeros(4, 4)}
    Checkpointer(str(tmp_path)).save(3, tree)
    ck = JaxCheckpointer(str(tmp_path))
    formats_by_name = {e["name"]: e["format"]
                       for e in ck.manifest(3)["leaves"]}
    assert "csr" in formats_by_name.values()
    like = jax.tree.map(lambda t: np.zeros(t.shape, np.float32),
                        {"layers": jp["layers"], "embed": jp["embed"],
                         "small": np.zeros((4, 4), np.float32)})
    got = ck.restore(3, like)
    for (path, a), t in zip(jax.tree_util.tree_leaves_with_path(got),
                            metrics.tree_leaves(tree)):
        np.testing.assert_array_equal(np.asarray(a), t.numpy(),
                                      err_msg=str(path))
