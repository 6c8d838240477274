"""repro_torch.sparse.compress.init_compressed (prune and compress part by
part on the params' device, the path of ``launch/serve --sparse``) against
``compress_params(prune_blocks_for_plan(model.init(gen), ...))`` (the
host numpy path, which tests/test_torch_compress.py holds against the JAX
package) on reduced models: the same dense residue, masks, tables and
block data, leaf for leaf, under plans that compress, that fall back to
dense, that pad slot counts and that quantize; the MoE family's expert
stacks as (L, E) stacks of slices, one palette per (layer, expert)."""
import dataclasses

import pytest
import torch

from repro_torch.models.model_zoo import build
from repro_torch.sparse import compress as tc
from repro_torch.sparse.formats import is_bcsr

ARCHS = ["smollm-360m", "rwkv6-3b", "recurrentgemma-9b", "olmoe-1b-7b",
         "llama4-scout-17b-a16e"]
PLANS = {
    "bcsr": (tc.CompressionPlan(), 0.8),
    "block_8x64": (tc.CompressionPlan(block=(8, 64), min_sparsity=0.3), 0.5),
    # 0.8 of the blocks pruned is below min_sparsity 0.9: every matrix
    # stays dense, pruned
    "dense_fallback": (tc.CompressionPlan(min_sparsity=0.9), 0.8),
    "slot_multiple": (tc.CompressionPlan(slot_multiple=3), 0.8),
    "palette8": (tc.CompressionPlan(quantize_bits=8), 0.8),
}


def _gen():
    return torch.Generator().manual_seed(0)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k], f"{prefix}/{k}")
    else:
        yield prefix, tree


def _assert_same(got, want, where):
    if is_bcsr(want):
        assert type(got) is type(want), where
        for f in dataclasses.fields(want):
            a, b = getattr(got, f.name), getattr(want, f.name)
            if isinstance(b, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), \
                    f"{where}.{f.name}"
            else:
                assert a == b, f"{where}.{f.name}"
    else:
        assert got.dtype == want.dtype and torch.equal(got, want), where


@pytest.mark.parametrize("plan_name", list(PLANS))
@pytest.mark.parametrize("arch", ARCHS)
def test_init_compressed_equals_host_path(arch, plan_name):
    plan, sparsity = PLANS[plan_name]
    model = build(arch, reduced=True, device="cpu")
    want = tc.compress_params(tc.prune_blocks_for_plan(
        model.init(_gen()), plan, sparsity), plan)
    got = tc.init_compressed(model, plan, sparsity, _gen())
    for part in ("dense", "sparse"):
        g = dict(_leaves(getattr(got, part)))
        w = dict(_leaves(getattr(want, part)))
        assert list(g) == list(w), part
        for path in w:
            _assert_same(g[path], w[path], f"{part}{path}")
    n_sparse = len(list(tc.iter_bcsr(want)))
    assert (n_sparse == 0) == (plan_name == "dense_fallback")


def test_init_compressed_draws_what_init_draws():
    """The generator ends where ``model.init`` leaves it, so a caller's
    next draws (the serve CLI's prompt) do not move."""
    model = build("recurrentgemma-9b", reduced=True, device="cpu")
    g1, g2 = _gen(), _gen()
    model.init(g1)
    tc.init_compressed(model, tc.CompressionPlan(), 0.8, g2)
    assert torch.equal(torch.rand(8, generator=g1), torch.rand(8, generator=g2))
