"""repro_torch.sparse.compress against repro.sparse.compress on reduced
models carried across as numpy: identical pruning masks, tables and data;
a palette within 1e-5 of the JAX one with code 0 mapping exactly to zero;
identical size reports."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core.metrics import model_size_bytes as jax_model_size_bytes
from repro.models.model_zoo import build as jax_build
from repro.sparse import compress as jc
from repro_torch.core.metrics import model_size_bytes
from repro_torch.core.quantize import kmeans_palette
from repro_torch.sparse import compress as tc
from repro_torch.sparse.formats import BlockCSR, PaletteBCSR
from torch_parity import format_fields, jax_numpy, to_port

PLANS = [jc.CompressionPlan(), jc.CompressionPlan(block=(8, 64), min_sparsity=0.3)]


def _port_plan(plan):
    return tc.CompressionPlan(**dataclasses.asdict(plan))


def _params(arch, seed=0):
    return jax_build(arch, reduced=True).init(jax.random.PRNGKey(seed))


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch", ["smollm-360m", "minitron-8b"])
@pytest.mark.parametrize("plan_i", [0, 1])
def test_prune_and_compress_identical(arch, plan_i):
    plan = PLANS[plan_i]
    params = _params(arch)
    jp = jc.prune_blocks_for_plan(params, plan, 0.9)
    tp = tc.prune_blocks_for_plan(to_port(params), _port_plan(plan), 0.9)
    for (name, a), (_, b) in zip(_leaves(jax.tree.map(jax_numpy, jp)),
                                 _leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert model_size_bytes(tp) == jax_model_size_bytes(jp, sparse=False)

    jcp = jc.compress_params(jp, plan)
    tcp = tc.compress_params(tp, _port_plan(plan))
    jl, tl = list(jc.iter_bcsr(jcp)), list(tc.iter_bcsr(tcp))
    assert [n for n, _ in tl] == [n for n, _ in jl] and jl
    for (name, jm), (_, tm) in zip(jl, tl):
        assert isinstance(tm, BlockCSR)
        want = format_fields(jm)
        for f in dataclasses.fields(tm):
            got = getattr(tm, f.name)
            if isinstance(got, torch.Tensor):
                assert got.numpy().dtype == want[f.name].dtype, (name, f.name)
                np.testing.assert_array_equal(got.numpy(), want[f.name],
                                              err_msg=f"{name} {f.name}")
            else:
                assert got == want[f.name], (name, f.name)
    for (name, a), (_, b) in zip(_leaves(jax.tree.map(jax_numpy, jcp.dense)),
                                 _leaves(tcp.dense)):
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert tc.compressed_size_bytes(tcp) == jc.compressed_size_bytes(jcp)
    assert tc.compression_summary(tcp) == jc.compression_summary(jcp)
    if arch == "minitron-8b":
        assert "head" in tcp.sparse          # untied head compressed


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_palette_and_zero_code(bits):
    plan = PLANS[1]
    jcp = jc.compress_params(jc.prune_blocks_for_plan(_params("smollm-360m"),
                                                      plan, 0.9), plan)
    tcp = to_port(jcp)
    jq, tq = jc.quantize_compressed(jcp, bits), tc.quantize_compressed(tcp, bits)
    assert tq.plan.quantize_bits == bits
    for (name, jm), (_, tm) in zip(jc.iter_bcsr(jq), tc.iter_bcsr(tq)):
        assert isinstance(tm, PaletteBCSR) and tm.bits == bits
        assert tm.codes.shape == tuple(jm.codes.shape)
        assert (tm.palette[..., 0] == 0).all()
        data = dict(tc.iter_bcsr(tcp))[name].data
        deq = tm.dequantize().data
        # code 0 <=> exact zero: the sparsity pattern survives exactly
        np.testing.assert_array_equal((deq == 0).numpy(), (data == 0).numpy())
        np.testing.assert_allclose(tm.palette.numpy(), jax_numpy(jm.palette),
                                   atol=1e-5, err_msg=name)
        np.testing.assert_allclose(deq.numpy(), jax_numpy(jm.dequantize().data),
                                   atol=1e-5, err_msg=name)
    assert tc.compressed_size_bytes(tq) == jc.compressed_size_bytes(jq)
    assert tc.bcsr_equiv_size_bytes(tq) == jc.bcsr_equiv_size_bytes(jq)
    assert tc.compression_summary(tq) == jc.compression_summary(jq)
    assert tc.format_size_report(1 << 20, 1 << 19, 1 << 17) == \
        jc.format_size_report(1 << 20, 1 << 19, 1 << 17)


def test_compress_with_quantizing_plan_emits_palette():
    plan = jc.CompressionPlan(block=(8, 64), min_sparsity=0.3, quantize_bits=4)
    tp = tc.prune_blocks_for_plan(to_port(_params("qwen3-0.6b")),
                                  _port_plan(plan), 0.9)
    tcp = tc.compress_params(tp, _port_plan(plan))
    leaves = list(tc.iter_bcsr(tcp))
    assert leaves and all(isinstance(m, PaletteBCSR) and m.bits == 4
                          for _, m in leaves)
    with pytest.raises(ValueError):
        tc.quantize_bcsr(leaves[0][1].dequantize(), 3)


def test_kmeans_edge_cases():
    pal, q, a = kmeans_palette(torch.zeros(4, 8), 15)
    assert (pal == 0).all() and (q == 0).all() and (a == 0).all()
    w = torch.tensor([0.0, 1.0, 0.0, 2.0, 1.0])        # fewer values than clusters
    pal, q, a = kmeans_palette(w, 7)
    assert torch.equal(q, w)
    assert {float(v) for v in pal[a[w != 0].long()]} == {1.0, 2.0}
