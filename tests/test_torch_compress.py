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


@pytest.mark.parametrize("arch", ["smollm-360m", "minitron-8b", "olmoe-1b-7b"])
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


@pytest.mark.parametrize("chunk", [5, 64, 1 << 15])
def test_kmeans_palette_chunked_matches_reference(chunk):
    """The final assignment (zeros included) is taken chunk by chunk, as
    in the reference: every chunk size gives the reference's palette,
    quantized weight and assignment (palette within 1e-6, the rest
    exact)."""
    from repro.core.quantize import kmeans_palette as jax_kmeans_palette
    rng = np.random.default_rng(3)
    w = rng.standard_normal((24, 40)).astype(np.float32)
    w[rng.random(w.shape) < 0.6] = 0.0
    pal, q, a = kmeans_palette(torch.from_numpy(w), 16, chunk=chunk)
    jp, jq, ja = (np.asarray(v) for v in
                  jax_kmeans_palette(jax.numpy.asarray(w), 16, chunk=chunk))
    np.testing.assert_allclose(pal.numpy(), jp, atol=1e-6)
    np.testing.assert_array_equal(a.numpy(), ja.reshape(-1))
    np.testing.assert_allclose(q.numpy(), jq, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_nearest_sorted_is_the_full_argmin(seed):
    """The card's k-means assignment (a binary search in each sorted
    palette) picks what the full argmin picks, first index on ties: values
    on palette entries, on midpoints, past both ends, and runs of equal
    entries (a cluster left empty keeps its value)."""
    from repro_torch.core.quantize import nearest_sorted
    g = torch.Generator().manual_seed(seed)
    for p in (2, 15, 255):
        pal = torch.sort(torch.randn(3, p, generator=g), dim=1).values
        if p > 4:
            pal[:, 2:5] = pal[:, 2:3]
        v = torch.randn(3, 600, generator=g) * 2
        v[:, :p] = pal
        v[:, p:2 * p - 1] = (pal[:, 1:] + pal[:, :-1]) / 2
        want = torch.argmin((v[..., None] - pal[:, None, :]).abs(), dim=-1)
        assert torch.equal(nearest_sorted(v, pal), want)



@pytest.mark.parametrize("group_bytes", [1, 3 * 64 * 20 * 8 * 16])
def test_kmeans_palettes_in_bounded_groups_equal_one_group(group_bytes,
                                                           monkeypatch):
    """A byte bound that splits the (layer, expert) slices of a stack into
    many groups (one slice a group, or three) gives the palettes and
    assignments of one group of all slices, exactly: each slice's
    arithmetic is its own."""
    from repro_torch.core import quantize
    rng = np.random.default_rng(21)
    slices = rng.standard_normal((7, 20, 8, 16)).astype(np.float32)
    slices[rng.random(slices.shape) < 0.5] = 0.0
    slices[4] = 0.0                                  # a slice with no value
    t = torch.from_numpy(slices)
    monkeypatch.setattr(quantize, "GROUP_BYTES", 1 << 40)
    want = quantize.kmeans_palettes(t, 15)
    monkeypatch.setattr(quantize, "GROUP_BYTES", group_bytes)
    got = quantize.kmeans_palettes(t, 15)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[1].dtype == torch.int32
    assert (got[1][t.reshape(7, -1) == 0] == 0).all()


def test_quantize_bcsr_in_bounded_groups_equals_one_group(monkeypatch):
    """``quantize_bcsr`` on reduced olmoe's (L, E) expert stacks: the codes
    and palettes with one slice a group equal those with one group."""
    from repro_torch.core import quantize
    plan = _port_plan(jc.CompressionPlan(block=(8, 16), min_sparsity=0.3))
    tcp = tc.compress_params(tc.prune_blocks_for_plan(
        to_port(_params("olmoe-1b-7b")), plan, 0.6), plan)
    stacks = [m for path, m in tc.iter_bcsr(tcp) if "/moe/" in path]
    assert stacks and all(m.data.dim() == 5 for m in stacks)
    want = [tc.quantize_bcsr(m, 4) for m in stacks]
    monkeypatch.setattr(quantize, "GROUP_BYTES", 1)
    for m, w in zip(stacks, want):
        got = tc.quantize_bcsr(m, 4)
        assert torch.equal(got.codes, w.codes)
        assert torch.equal(got.palette, w.palette)
