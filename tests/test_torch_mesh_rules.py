"""The mesh slice's host-side pieces against the JAX package, no
processes: the placement rules leaf by leaf, the ``--mesh`` flag, the
elastic re-scaling plan, the int8 gradient compression, and the block-row
shards of the compressed formats."""
from __future__ import annotations

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcoll
from repro.distributed import elastic as jelastic
from repro.distributed import sharding as jshd
from repro.models.model_zoo import build as jax_build
from repro_torch.configs import all_configs, get_config
from repro_torch.core.tree import flatten_with_path, keystr
from repro_torch.distributed import collectives, elastic, sharding
from repro_torch.kernels.bsr_spmm import ref as kref
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models.model_zoo import build
from repro_torch.sparse.compress import (CompressionPlan, compress_params,
                                         iter_bcsr, prune_blocks_for_plan)
from repro_torch.sparse.formats import (compact_rows, dense_to_bcsr,
                                        join_rows, split_rows)
from torch_parity import block_sparse

MESHES = [(1, 1), (2, 2), (2, 4), (16, 16), (2, 16, 16)]
FAMILIES = sorted(all_configs())


def _stub(shape: tuple):
    names = ("data", "model") if len(shape) == 2 else ("pod", "data", "model")
    return types.SimpleNamespace(shape=dict(zip(names, shape)))


def _ref_spec(path: str, shape, mesh) -> tuple:
    leaf = jax.ShapeDtypeStruct(tuple(shape), jnp.float32)
    return tuple(jshd._axes_to_spec(jshd._leaf_axes(path, leaf), leaf.shape,
                                    mesh, jshd.PARAM_RULES))


def _pad(spec: tuple, n: int) -> tuple:
    return tuple(spec) + (None,) * (n - len(spec))


def _jax_shapes(arch: str, reduced: bool) -> dict:
    model = jax_build(arch, reduced=reduced)
    return jax.eval_shape(model.init, jax.random.PRNGKey(0))


def _jax_leaves(tree) -> dict:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): leaf.shape for p, leaf in flat}


@pytest.mark.parametrize("arch,reduced", [(a, True) for a in FAMILIES]
                         + [("smollm-360m", False), ("olmoe-1b-7b", False)])
def test_dense_leaf_axes_match_the_reference(arch, reduced):
    """Every leaf's mesh axis per dim on every mesh equals the
    reference's; the port's leaves are the reference's, path and shape."""
    params = build(arch, reduced=reduced, device="meta").init(device="meta")
    port = {keystr(k): tuple(t.shape) for k, t in flatten_with_path(params)}
    assert port == _jax_leaves(_jax_shapes(arch, reduced))
    for shape in MESHES:
        stub = _stub(shape)
        specs = sharding.param_specs(params, stub)
        for keys, spec in flatten_with_path(specs):
            path = keystr(keys)
            want = _pad(_ref_spec(path, port[path], stub), len(port[path]))
            assert spec == want, (arch, shape, path, spec, want)


# Compressed leaves that the reference splits on a 16-wide axis and the
# port keeps whole: with slot counts padded to the lcm of the mesh's axis
# sizes (as both packages' launchers pad them under a mesh) the
# reference's slot axis always divides, but a split by rows needs the
# block-row count to divide, and at the reduced widths (8 block rows of 8
# for d = 64) these leaves' do not. On the meshes (16, 16) and
# (2, 16, 16); on the others every leaf takes the reference's axis.
WIDE = ((16, 16), (2, 16, 16))
_REPLICATED_IN_THE_PORT = {  # arch -> paths
    "command-r-plus-104b": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/mlp/wo",
    ),
    "llama4-scout-17b-a16e": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/moe/ewg",
        "layers/b0_attn/moe/ewi",
        "layers/b0_attn/moe/ewo",
    ),
    "minitron-8b": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/mlp/wo",
    ),
    "musicgen-medium": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/mlp/wo",
    ),
    "olmoe-1b-7b": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/moe/ewg",
        "layers/b0_attn/moe/ewi",
        "layers/b0_attn/moe/ewo",
    ),
    "paligemma-3b": (
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/mlp/wo",
    ),
    "qwen3-0.6b": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/mlp/wo",
    ),
    "recurrentgemma-9b": (
        "layers/b0_rglru/mlp/wo",
        "layers/b0_rglru/rec/lru_gate",
        "layers/b0_rglru/rec/lru_in",
        "layers/b0_rglru/rec/lru_out",
        "layers/b1_rglru/mlp/wo",
        "layers/b1_rglru/rec/lru_gate",
        "layers/b1_rglru/rec/lru_in",
        "layers/b1_rglru/rec/lru_out",
        "layers/b2_attn/attn/wo",
        "layers/b2_attn/attn/wq",
        "layers/b2_attn/mlp/wo",
        "rem/r0_rglru/mlp/wo",
        "rem/r0_rglru/rec/lru_gate",
        "rem/r0_rglru/rec/lru_in",
        "rem/r0_rglru/rec/lru_out",
        "rem/r1_rglru/mlp/wo",
        "rem/r1_rglru/rec/lru_gate",
        "rem/r1_rglru/rec/lru_in",
        "rem/r1_rglru/rec/lru_out",
    ),
    "rwkv6-3b": (
        "layers/b0_rwkv/cm/cm_r",
        "layers/b0_rwkv/cm/cm_v",
        "layers/b0_rwkv/tm/rwkv_g",
        "layers/b0_rwkv/tm/rwkv_k",
        "layers/b0_rwkv/tm/rwkv_o",
        "layers/b0_rwkv/tm/rwkv_r",
        "layers/b0_rwkv/tm/rwkv_v",
    ),
    "smollm-360m": (
        "layers/b0_attn/attn/wk",
        "layers/b0_attn/attn/wo",
        "layers/b0_attn/attn/wq",
        "layers/b0_attn/attn/wv",
        "layers/b0_attn/mlp/wo",
    ),
}


def _pruned(arch: str):
    model = build(arch, reduced=True, device="cpu")
    plan = CompressionPlan(block=(8, 16), min_sparsity=0.5)
    params = model.init(torch.Generator().manual_seed(0))
    return prune_blocks_for_plan(params, plan, 0.75), plan


@pytest.mark.parametrize("arch", FAMILIES)
def test_bcsr_row_axes_match_the_reference(arch):
    """A compressed leaf takes its dense out-dim rule's axis for its block
    rows, as the reference's ``_bcsr_row_spec`` does for its slots, except
    where the block rows do not divide (listed by name)."""
    pruned, plan = _pruned(arch)
    seen: dict = {}
    for shape in MESHES:
        stub = _stub(shape)
        mult = int(np.lcm.reduce(list(shape)))
        cp = compress_params(pruned, dataclasses.replace(
            plan, slot_multiple=mult))
        leaves = list(iter_bcsr(cp))
        assert leaves, arch
        for path, m in leaves:
            ks = "".join(f"['{k}']" for k in path.split("/"))
            data = jax.ShapeDtypeStruct(tuple(m.data.shape), jnp.float32)
            ref_spec = tuple(jshd._bcsr_row_spec(ks, data, stub,
                                                 jshd.PARAM_RULES))
            slot_axis = m.data.dim() - 3
            ref = ref_spec[slot_axis] if len(ref_spec) > slot_axis else None
            got = sharding.bcsr_row_axis(ks, m.block_grid[0], stub)
            if got != ref:
                size = stub.shape[ref]
                assert got is None and m.block_grid[0] % size, \
                    (arch, shape, path, ref, got)
                seen.setdefault(path, []).append(shape)
    want = {p: list(WIDE) for p in _REPLICATED_IN_THE_PORT.get(arch, ())}
    assert seen == want, (arch, seen)


def test_mesh_flag_and_its_errors():
    assert mesh_lib.parse_mesh_flag("none") is None
    assert mesh_lib.mesh_from_flag("none") is None
    assert mesh_lib.parse_mesh_flag("2,4") == (2, 4)
    assert mesh_lib.parse_mesh_flag("single") == (16, 16)
    assert mesh_lib.parse_mesh_flag("multi") == (2, 16, 16)
    with pytest.raises(SystemExit, match="none|single|multi|DATA,MODEL"):
        mesh_lib.parse_mesh_flag("2x2")
    with pytest.raises(SystemExit, match="needs 4 devices but only 1"):
        mesh_lib.mesh_from_flag("2,2")
    with pytest.raises(RuntimeError, match="needs 256 devices but only 1"):
        mesh_lib.mesh_from_flag("single")
    with pytest.raises(RuntimeError, match="needs 512 devices"):
        mesh_lib.mesh_from_flag("multi")


@pytest.mark.parametrize("old", [{"data": 2, "model": 2},
                                 {"data": 16, "model": 16},
                                 {"pod": 2, "data": 16, "model": 16}])
def test_rescale_plan_matches_the_reference(old):
    for new in ({"data": 1, "model": 1}, {"data": 4, "model": 1},
                {"data": 3, "model": 2}, {"pod": 2, "data": 8, "model": 4}):
        for batch in (1, 6, 8, 64, 96):
            assert elastic.rescale_plan(old, new, batch) == \
                jelastic.rescale_plan(old, new, batch)


def test_int8_compression_matches_the_reference():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(33, 17)).astype(np.float32),
             "b": {"c": (rng.normal(size=(64,)) * 1e-3).astype(np.float32)},
             "z": np.zeros((5,), np.float32)}
    for leaf in (grads["a"], grads["b"]["c"], grads["z"]):
        q, s = collectives.quantize_int8(torch.from_numpy(leaf))
        jq, js = jcoll.quantize_int8(jnp.asarray(leaf))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-7)
        np.testing.assert_allclose(
            collectives.dequantize_int8(q, s).numpy(),
            np.asarray(jcoll.dequantize_int8(jq, js)), rtol=1e-6, atol=0)
    tg = {"a": torch.from_numpy(grads["a"]),
          "b": {"c": torch.from_numpy(grads["b"]["c"])},
          "z": torch.from_numpy(grads["z"])}
    err = jerr = None
    for _ in range(3):
        new, err = collectives.ef_compress_grads(tg, err)
        jnew, jerr = jcoll.ef_compress_grads(jax.tree.map(jnp.asarray, grads),
                                             jerr)
        for (k, t), (_, j) in zip(flatten_with_path(new),
                                  flatten_with_path(jnew)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-9, err_msg=str(k))
        for (k, t), (_, j) in zip(flatten_with_path(err),
                                  flatten_with_path(jerr)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                       atol=1e-9, err_msg=str(k))


@pytest.mark.parametrize("shape,block,n", [((64, 48), (8, 16), 2),
                                           ((64, 48), (8, 16), 4),
                                           ((44, 40), (8, 8), 3)])
def test_row_shards_compute_what_the_whole_store_computes(shape, block, n):
    """Each shard is a self-contained store: its product is the whole's
    rows, its transposed product the whole's share; joined they are the
    whole, and compacted its very fields."""
    rng = np.random.default_rng(1)
    w = block_sparse(rng, *shape, block, 0.4)
    m = dense_to_bcsr(w, block)
    if m.block_grid[0] % n:
        with pytest.raises(ValueError, match="do not split"):
            split_rows(m, n)
        return
    shards = split_rows(m, n)
    x = torch.from_numpy(rng.normal(size=(3, shape[1])).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(3, shape[0])).astype(np.float32))
    np.testing.assert_array_equal(
        torch.cat([kref.spmm_fwd_ref(x, s) for s in shards], -1).numpy(),
        kref.spmm_fwd_ref(x, m).numpy())
    rows = np.cumsum([0] + [s.shape[0] for s in shards])
    dx = sum(kref.spmm_bwd_ref(dy[:, rows[j]:rows[j + 1]], s)
             for j, s in enumerate(shards))
    np.testing.assert_allclose(dx.numpy(), kref.spmm_bwd_ref(dy, m).numpy(),
                               rtol=1e-5, atol=1e-5)
    joined = join_rows(shards)
    np.testing.assert_array_equal(joined.to_dense()[:shape[0]].numpy(),
                                  m.to_dense()[:shape[0]].numpy())
    back = compact_rows(joined)
    for f in dataclasses.fields(m):
        a, b = getattr(m, f.name), getattr(back, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_stacked_row_shards_pad_to_one_slot_count():
    """A layer-stacked store splits slice by slice; every shard of every
    slice has one slot count and the whole store's gather width."""
    rng = np.random.default_rng(2)
    arch = "smollm-360m"
    cfg = get_config(arch).reduced()
    assert cfg.n_super_blocks >= 2
    pruned, plan = _pruned(arch)
    cp = compress_params(pruned, plan)
    for path, m in iter_bcsr(cp):
        if m.data.dim() != 4 or m.block_grid[0] % 2:
            continue
        shards = split_rows(m, 2)
        assert {s.data.shape for s in shards} == {shards[0].data.shape}
        assert shards[0].gather_idx.shape[-1] == m.gather_idx.shape[-1]
        joined = join_rows(shards)
        for i in range(m.data.shape[0]):
            np.testing.assert_array_equal(joined[i].to_dense().numpy(),
                                          m[i].to_dense().numpy())
        x = torch.from_numpy(rng.normal(size=(2, m.shape[1])).astype(
            np.float32))
        np.testing.assert_array_equal(
            torch.cat([kref.spmm_fwd_ref(x, s[1]) for s in shards],
                      -1).numpy(),
            kref.spmm_fwd_ref(x, m[1]).numpy())
