"""Helpers shared by the ``test_torch_*`` parity tests: carry JAX-side
weights across to ``repro_torch`` as numpy, and build block-sparse inputs
from a seed. Only the tests import both packages."""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models.model_zoo import build as jax_build
from repro.sparse import compress as jc
from repro.sparse.compress import CompressedParams as JaxCompressedParams
from repro.sparse.formats import BlockCSR as JaxBlockCSR
from repro.sparse.formats import PaletteBCSR as JaxPaletteBCSR
from repro_torch.checkpoint import bridge
from repro_torch.models.model_zoo import build
from repro_torch.sparse.compress import CompressionPlan

_META = ("shape", "block", "n_blocks", "bits")


def block_sparse(rng, n, k, block, density) -> np.ndarray:
    """(n, k) f32 matrix whose (br, bc) blocks (ragged at the edges) are
    each nonzero with probability ``density``."""
    br, bc = block
    w = np.zeros((n, k), np.float32)
    for i in range(0, n, br):
        for j in range(0, k, bc):
            if rng.random() < density:
                blk = w[i:i + br, j:j + bc]
                blk[...] = rng.normal(size=blk.shape)
    return w


def format_fields(m) -> dict:
    """A JAX BlockCSR / PaletteBCSR as a dict of numpy fields + metadata."""
    return {f.name: (getattr(m, f.name) if f.name in _META
                     else np.asarray(getattr(m, f.name)))
            for f in dataclasses.fields(m)}


def _numpy_tree(tree):
    if isinstance(tree, (JaxBlockCSR, JaxPaletteBCSR)):
        return format_fields(tree)
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def to_port(params, device="cpu"):
    """JAX params (a dict tree or a ``CompressedParams``) -> the port's."""
    if isinstance(params, JaxCompressedParams):
        plan = CompressionPlan(**dataclasses.asdict(params.plan))
        return bridge.compressed_from_numpy(
            _numpy_tree(params.dense), _numpy_tree(params.sparse), plan,
            device)
    return bridge.params_from_numpy(_numpy_tree(params), device)


def port_format(m, device="cpu"):
    """One JAX BlockCSR / PaletteBCSR -> the port's."""
    return bridge.format_from_fields(format_fields(m), device)


def jax_numpy(x) -> np.ndarray:
    return np.asarray(jax.device_get(x))


def jax_reduced_params(model, weights: str, block, seed: int, sparsity=0.8):
    """Random reduced params of a JAX model: dense, or pruned and
    compressed to BlockCSR ('bcsr') or PaletteBCSR ('pal8' / 'pal4')."""
    params = model.init(jax.random.PRNGKey(seed))
    if weights == "dense":
        return params
    plan = jc.CompressionPlan(block=block, min_sparsity=0.3,
                              quantize_bits={"pal8": 8, "pal4": 4}.get(weights))
    cp = jc.compress_params(jc.prune_blocks_for_plan(params, plan, sparsity),
                            plan)
    assert list(jc.iter_bcsr(cp)), "nothing compressed"
    return cp


def check_logits_match(arch: str, weights: str, block, tol: float = 1e-4):
    """apply_train, prefill and one decode step of the reduced ``arch``
    agree with the JAX package within ``tol`` on the same weights. An arch
    with a frontend (paligemma-3b, musicgen-medium) is fed (B, S, d)
    embeddings drawn with numpy in place of token ids, as its frontend
    stand-in provides them."""
    jm = jax_build(arch, reduced=True)
    tm = build(arch, reduced=True, device="cpu")
    jp = jax_reduced_params(jm, weights, block, seed=1)
    tp = to_port(jp)
    rng = np.random.default_rng(2)
    b, s = 2, 8

    def inputs(n):
        if jm.cfg.frontend != "none":
            return (0.02 * rng.normal(size=(b, n, jm.cfg.d_model))).astype(
                np.float32)
        return rng.integers(0, jm.cfg.vocab, size=(b, n)).astype(np.int32)

    prompt = inputs(s)
    tprompt = torch.tensor(prompt)

    j_train, _ = jm.apply_train(jp, {"inputs": jnp.asarray(prompt)})
    t_train, _ = tm.apply_train(tp, {"inputs": tprompt})
    np.testing.assert_allclose(t_train.numpy(), np.asarray(j_train), atol=tol)

    jl, jcache = jm.prefill(jp, jnp.asarray(prompt), jm.init_cache(b, s + 2))
    tl, tcache = tm.prefill(tp, tprompt, tm.init_cache(b, s + 2))
    assert tl.dtype == torch.float32 and tl.shape == (b, jm.cfg.vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol)

    tok = inputs(1)
    jd, _ = jm.decode_step(jp, jnp.asarray(tok), jcache, jnp.int32(s))
    td, _ = tm.decode_step(tp, torch.tensor(tok), tcache, s)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=tol)
