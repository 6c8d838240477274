"""Each expert's occupied rows through the MoE layer and the expert spmm, on
the CPU.

The MoE dispatch of ``repro_torch.models.moe`` hands the expert forward
the count of tokens it gave each expert, capped at the capacity (an (E,)
int32 tensor); the kernels compute those rows only and write zeros below.
Here:

* the plain versions (``kernels/bsr_spmm/ref.py``, which the wrappers run
  for CPU tensors) with counts equal those without on the rows below each
  count, bit for bit, and are exact zeros past it: counts 0, 1, a partial
  count and M, at M = 1, 8, 16, 40 and 128, for BlockCSR (f32 and bf16
  stores) and PaletteBCSR-8 and -4;
* the lane mapping of the CUDA kernel (``csrc/bsr_spmm_experts.cu``: lane
  (g, t) loads columns 32 q + 8 t + i of a 128-column chunk and feeds them
  to mma.sync m16n8k16 as k = 2 t, 2 t + 1, 2 t + 8, 2 t + 9 of each k-step),
  rehearsed in numpy on the fragment layouts of the PTX ISA: it sums each
  column's product exactly once;
* the counts equal the per-expert sum of the reference's dispatch
  (``repro/models/moe.py``, the kept one-hot entries), capped at cap;
* ``apply_moe`` with the counts is bit-equal to the same layer run without
  them (f32 and bf16), and within the 1e-5 of ``tests/test_torch_moe.py``
  of the JAX package's ``apply_moe`` at reduced olmoe-1b-7b, with and
  without dropped choices.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models.model_zoo import build as jax_build
from repro_torch.kernels.bsr_spmm import ops as kops
from repro_torch.kernels.bsr_spmm import ref as kref
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build
from repro_torch.sparse import ops as sparse_ops
from repro_torch.sparse.compress import CompressionPlan, _pad_stack, quantize_bcsr
from repro_torch.sparse.formats import dense_to_bcsr
from torch_parity import jax_reduced_params, to_port

ATOL = 1e-5          # of the largest |y|, as tests/test_torch_moe.py
STORES = ["float32", "bfloat16", "palette8", "palette4"]


def _stack(store: str, e=4, n=48, k=160, block=(8, 32), seed=0):
    """E BlockCSR slices of (n, k) at block densities 0.1-0.6 (expert 0
    empty), stacked as the compression stacks them, in ``store``."""
    rng = np.random.default_rng(seed)
    br, bc = block
    ms = []
    for i in range(e):
        keep = rng.random((-(-n // br), -(-k // bc))) < (0.0 if i == 0 else
                                                         0.1 + 0.5 * i / e)
        mask = np.kron(keep, np.ones(block, bool))[:n, :k]
        ms.append(dense_to_bcsr((rng.normal(size=(n, k)) * mask)
                                .astype(np.float32), block))
    w = _pad_stack(ms, CompressionPlan(min_sparsity=0.0), (e,), 1 << 40)
    if store.startswith("palette"):
        return quantize_bcsr(w, int(store[7:]))
    return dataclasses.replace(w, data=w.data.to(getattr(torch, store)))


@pytest.mark.parametrize("store", STORES)
@pytest.mark.parametrize("m", [1, 8, 16, 40, 128])
def test_plain_versions_with_counts(store, m):
    """Rows below each count as without counts, exact zeros past it; the
    same through the CPU wrapper (its plain version) and sparse_matmul."""
    w = _stack(store)
    e = w.gather_nnz.shape[0]
    palette = store.startswith("palette")
    plain = (kref.spmm_palette_experts_fwd_ref if palette
             else kref.spmm_experts_fwd_ref)
    wrapper = kops.spmm_palette_experts if palette else kops.spmm_experts
    counts = [0, 1, max(m // 3, 1), m]
    rows = torch.tensor(counts, dtype=torch.int32)
    x = torch.tensor(np.random.default_rng(m).normal(size=(e, m, w.shape[1])),
                     dtype=torch.float32)
    for xd in (x, x.bfloat16()):
        every = plain(xd, w)
        got = plain(xd, w, rows)
        assert got.dtype == torch.float32 and got.shape == every.shape
        for i, r in enumerate(counts):
            assert torch.equal(got[i, :r], every[i, :r])
            assert torch.equal(got[i, r:], torch.zeros_like(got[i, r:]))
        assert torch.equal(wrapper(xd, w, rows), got)
        assert torch.equal(sparse_ops.sparse_matmul(xd, w, rows=rows),
                           got.to(xd.dtype))
        assert torch.equal(sparse_ops.sparse_matmul(xd, w, "cuda", rows=rows),
                           got)
    with pytest.raises(ValueError, match="3-D"):
        sparse_ops.sparse_matmul(x[0], w[0], rows=rows)


def _fragment_products(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Y (16, 8) of one m-tile and one n-tile over one 128-column chunk as
    the kernel computes it: every lane's registers placed where the PTX
    ISA's m16n8k16 fragment layouts put them (A: a0 row g, k 2t / 2t + 1;
    a1 row g + 8; a2 and a3 at k + 8; B: b0 k 2t / 2t + 1, column g; b1 at
    k + 8), one product a k-step, read back from the C layout (c0 / c1 row
    g, columns 2t / 2t + 1; c2 / c3 row g + 8)."""
    acc = np.zeros((16, 8))
    seen = np.zeros((8, 4, 4), int)           # (kk, t, slot): columns used
    for kk in range(8):
        a, b = np.full((16, 16), np.nan), np.full((16, 8), np.nan)
        for lane in range(32):
            g, t = lane // 4, lane % 4
            cols = [32 * q + 8 * t + i for q in range(4) for i in range(8)]
            xa, xb, wv = x[g, cols], x[g + 8, cols], w[g, cols]
            v = slice(4 * kk, 4 * kk + 4)
            for row, vals in ((g, xa[v]), (g + 8, xb[v])):
                a[row, [2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9]] = vals
            b[[2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9], g] = wv[v]
            seen[kk, t] = [cols[4 * kk + s] for s in range(4)]
        assert not np.isnan(a).any() and not np.isnan(b).any()
        acc += a @ b
    # each of the chunk's 128 columns feeds exactly one k of one k-step
    assert sorted(seen.ravel().tolist()) == list(range(128))
    out = np.zeros((16, 8))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        out[g, 2 * t:2 * t + 2] = acc[g, 2 * t:2 * t + 2]
        out[g + 8, 2 * t:2 * t + 2] = acc[g + 8, 2 * t:2 * t + 2]
    return out


@pytest.mark.parametrize("bc", [128, 64, 40])
def test_lane_mapping_sums_each_column_once(bc):
    """The kernel's lane mapping against X @ W' over one chunk of a block
    (columns past bc load as zero in both operands, as the kernel's masked
    loads give them); integer values, so the sums are exact."""
    rng = np.random.default_rng(bc)
    x = rng.integers(-8, 9, (16, 128)).astype(np.float64)
    w = rng.integers(-8, 9, (8, 128)).astype(np.float64)
    x[:, bc:] = w[:, bc:] = 0.0
    np.testing.assert_array_equal(_fragment_products(x, w), x @ w.T)


@pytest.mark.parametrize("cap", [2, 5, 64])
def test_counts_are_the_references_kept_pairs(cap):
    """The (E,) counts the port's dispatch hands the expert forward equal
    the per-expert sum of the reference's kept one-hot entries (its
    running count and keep test, as ``repro/models/moe.py`` writes them),
    int32, with and without overflow."""
    rng = np.random.default_rng(cap)
    n_e, t, k = 8, 24, 2
    idx = np.stack([rng.choice(n_e, k, replace=False,
                               p=[0.3, 0.2, 0.1, 0.1, 0.1, 0.1, 0.1, 0.0])
                    for _ in range(t)])
    flat_e = jnp.asarray(idx.reshape(-1))
    eoh = jax.nn.one_hot(flat_e, n_e, dtype=jnp.int32)
    pos_in_e = jnp.sum(jnp.cumsum(eoh, axis=0) * eoh, axis=-1) - 1
    keep = pos_in_e < cap
    want = np.asarray(jnp.sum(eoh * keep[:, None], axis=0))
    rows, got = tmoe._dispatch(torch.tensor(idx), n_e, cap)
    assert got.dtype == torch.int32 and got.shape == (n_e,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((rows < n_e * cap).sum())
    assert (cap == 64) == bool((got < cap).all())


def _layer0(tree, jax_tree: bool):
    if jax_tree:
        return jax.tree.map(lambda a: a[0], tree)
    if isinstance(tree, dict):
        return {k: _layer0(v, False) for k, v in tree.items()}
    return tree[0]


@functools.lru_cache(maxsize=None)
def _olmoe(weights: str):
    """(JAX cfg, port cfg, JAX layer-0 MoE params and compressed experts,
    the port's) of reduced olmoe-1b-7b, (8, 64) blocks."""
    jm = jax_build("olmoe-1b-7b", reduced=True)
    tm = build("olmoe-1b-7b", reduced=True, device="cpu")
    jp = jax_reduced_params(jm, weights, (8, 64), seed=1)
    tp = to_port(jp)
    moe = ("layers", "b0_attn", "moe")

    def at(tree):
        for key in moe:
            tree = tree[key]
        return tree
    return (jm.cfg, tm.cfg, _layer0(at(jp.dense), True),
            _layer0(at(jp.sparse), True), _layer0(at(tp.dense), False),
            _layer0(at(tp.sparse), False))


def _with_capacity(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


class _Counts:
    """Within the block, every ``sparse_matmul`` of the MoE layer records
    the counts it was given; with ``drop``, it runs without them."""

    def __init__(self, monkeypatch, drop: bool):
        self.seen, inner = [], sparse_ops.sparse_matmul

        def call(x, w, backend="auto", f32=False, rows=None):
            self.seen.append(rows)
            return inner(x, w, backend, f32, None if drop else rows)
        monkeypatch.setattr(tmoe.sparse_ops, "sparse_matmul", call)


@pytest.mark.parametrize("weights", ["bcsr", "pal8", "pal4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cf", [None, 0.25])
def test_apply_moe_bit_equal_without_counts(monkeypatch, weights, dtype, cf):
    """The layer's output and aux losses with the counts equal those of
    the same layer whose expert products ignore them, bit for bit; the
    counts reach all three expert projections; at the config's capacity
    factor some expert holds fewer rows than its capacity (so rows were
    skipped), at 0.25 every expert is full (choices were dropped)."""
    _, tcfg, _, _, tp, tsp = _olmoe(weights)
    if cf is not None:
        tcfg = _with_capacity(tcfg, cf)
    x = torch.tensor(np.random.default_rng(4).normal(
        size=(2, 16, tcfg.d_model)), dtype=dtype)
    runs = []
    for drop in (False, True):
        with monkeypatch.context() as mp:
            counts = _Counts(mp, drop)
            with torch.no_grad():
                runs.append(tmoe.apply_moe(tp, x, tcfg, sparse=tsp))
        assert len(counts.seen) == 3 and all(r is not None
                                             for r in counts.seen)
    (y, aux), (y0, aux0) = runs
    assert y.dtype == dtype and torch.equal(y, y0)
    for key in aux:
        assert torch.equal(aux[key], aux0[key])
    cap = tmoe._capacity(32, tcfg.moe)
    rows = counts.seen[0]
    assert rows.dtype == torch.int32 and int(rows.max()) <= cap
    assert bool((rows < cap).any()) if cf is None else bool((rows == cap).all())


@pytest.mark.parametrize("weights", ["bcsr", "pal8"])
@pytest.mark.parametrize("cf", [None, 0.25])
def test_apply_moe_with_counts_matches_jax(weights, cf):
    """The layer with the counts against the JAX package's ``apply_moe``
    (which computes every row of every expert's buffer), with the
    config's capacity factor and at 0.25, where most choices overflow."""
    jcfg, tcfg, jp, jsp, tp, tsp = _olmoe(weights)
    if cf is not None:
        jcfg, tcfg = _with_capacity(jcfg, cf), _with_capacity(tcfg, cf)
    x = np.random.default_rng(5).normal(size=(4, 16, jcfg.d_model)) \
        .astype(np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, sparse=jsp)
    ty, taux = tmoe.apply_moe(tp, torch.tensor(x), tcfg, sparse=tsp)
    jy = np.asarray(jy)
    np.testing.assert_allclose(ty.numpy(), jy,
                               atol=ATOL * float(np.abs(jy).max()))
    for key in ("load_balance", "z_loss"):
        np.testing.assert_allclose(float(taux[key]), float(jaux[key]),
                                   rtol=ATOL, err_msg=key)
