"""The port's engine on the recurrent families against the JAX engine.

The cases of ``tests/test_engine_recurrent.py`` for reduced rwkv6-3b (pure
RWKV: no attention layer, so no pages) and recurrentgemma-9b (2:1 RG-LRU :
local attention with two remainder RG-LRU layers): both engines serve the
same weights (carried across as numpy) and the same requests. Greedy
tokens must be identical, and so must the run's ``n_ticks``,
``n_prefill_chunks``, ``n_preemptions`` and ``tick_widths``; the port's
engine tokens also equal the port's own ``generate``. Then: state zeroed
on recycle, the ``slot_resource_bytes`` split, preempt and resume, and the
prefix-cache refusal with the reference's error.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.model_zoo import build as jax_build
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro.serve import paged_kv as jpaged
from repro.sparse.compress import (CompressionPlan, compress_params,
                                   prune_blocks_for_plan)
from repro_torch.core.metrics import tree_leaves
from repro_torch.models.model_zoo import build
from repro_torch.serve import api
from repro_torch.serve import paged_kv
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.step import generate
from torch_parity import to_port

GEN = 5
PLAN = CompressionPlan(block=(8, 64), min_sparsity=0.3, min_size=4096)
STATS = ("n_ticks", "n_prefill_chunks", "n_preemptions", "n_requests",
         "n_generated", "n_prompt", "kv_page_bytes", "state_slot_bytes")


@pytest.fixture(scope="module", params=["rwkv6-3b", "recurrentgemma-9b"])
def setup(request):
    jm = jax_build(request.param, reduced=True)
    tm = build(request.param, reduced=True, device="cpu")
    jp = jm.init(jax.random.PRNGKey(0))
    return request.param, jm, tm, (jp, to_port(jp))


def _prompts(lens, vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _engines(jm, tm, params, **kw):
    jp, tp = params
    return (jengine.ServeEngine(jm, jp, jengine.EngineConfig(**kw)),
            ServeEngine(tm, tp, EngineConfig(**kw)))


def _run_both(jm, tm, params, lens, *, max_batch, gen=GEN, seed=7):
    prompts = _prompts(lens, jm.cfg.vocab, seed)
    je, te = _engines(jm, tm, params, max_batch=max_batch, prefill_chunk=8,
                      page_size=4, max_seq_len=max(lens) + gen)
    out_j = je.run([japi.Request(prompt=p, max_new_tokens=gen) for p in prompts])
    out_t = te.run([api.Request(prompt=p, max_new_tokens=gen) for p in prompts])
    assert set(out_t["results"]) == set(out_j["results"])
    for rid, want in out_j["results"].items():
        np.testing.assert_array_equal(np.asarray(out_t["results"][rid]),
                                      np.asarray(want), err_msg=f"rid {rid}")
    for key in STATS:
        assert out_t["stats"][key] == out_j["stats"][key], key
    assert te.tick_widths == je.tick_widths
    for rid, p in enumerate(prompts):
        want = generate(tm, params[1], torch.tensor(p)[None], gen)[0]
        np.testing.assert_array_equal(np.asarray(out_t["results"][rid]),
                                      want.numpy(), err_msg=f"generate {rid}")
    return je, te, out_t


def test_mixed_batch_token_parity(setup):
    """4 concurrent mixed-length requests, prompts on both sides of the
    prefill chunk: chunked prefill interleaved with decode."""
    _, jm, tm, params = setup
    _, te, _ = _run_both(jm, tm, params, [5, 12, 3, 20], max_batch=4)
    assert te.scheduler.n_prefill_chunks > 4
    assert te.tick_widths == {1, 8}


def test_compressed_parity(setup):
    """BlockCSR weights: the recurrent projections run sparse_matmul in the
    engine's mixed step."""
    _, jm, tm, params = setup
    cp = compress_params(prune_blocks_for_plan(params[0], PLAN, 0.75), PLAN)
    _run_both(jm, tm, (cp, to_port(cp)), [5, 12, 3], max_batch=3)


def test_churn_keeps_tick_widths(setup):
    """More requests than slots: admissions, finishes and slot recycling
    across waves add no tick width."""
    _, jm, tm, params = setup
    _, te, out = _run_both(jm, tm, params, [5, 12, 3, 9, 6, 14], max_batch=2)
    assert out["stats"]["n_requests"] == 6
    assert te.tick_widths == {1, 8}


def _state_leaves(pools):
    return [leaf for group in ("layers", "rem")
            for layer in (pools.get(group) or {}).values()
            for key, sub in layer.items() if key != "attn"
            for leaf in tree_leaves(sub)]


def test_state_zeroed_on_recycle(setup):
    """After a drain every state-pool leaf is zero, and a second wave on
    the same engines still agrees (recycled slots all around)."""
    _, jm, tm, params = setup
    je, te, _ = _run_both(jm, tm, params, [7, 11, 4], max_batch=2)
    leaves = _state_leaves(te.pools)
    assert leaves
    for leaf in leaves:
        assert not leaf.any()
    prompts = _prompts([9, 5], jm.cfg.vocab, seed=11)
    out_j = je.run([japi.Request(prompt=p, max_new_tokens=GEN) for p in prompts])
    out_t = te.run([api.Request(prompt=p, max_new_tokens=GEN) for p in prompts])
    assert out_t["results"].keys() == out_j["results"].keys()
    for rid, want in out_j["results"].items():
        np.testing.assert_array_equal(np.asarray(out_t["results"][rid]),
                                      np.asarray(want))


def test_slot_resource_bytes_split(setup):
    """Pure RWKV pools are all state; the hybrid carries both kinds; the
    split equals the JAX package's and sums to the total."""
    arch, jm, tm, _ = setup
    want = jpaged.slot_resource_bytes(jpaged.init_paged_cache(jm, 9, 4,
                                                              capacity=4))
    pools = paged_kv.init_paged_cache(tm, 9, 4, capacity=4)
    got = paged_kv.slot_resource_bytes(pools)
    assert got == want
    assert got["state_slot_bytes"] > 0
    assert (got["kv_page_bytes"] == 0) == (arch == "rwkv6-3b")
    assert sum(got.values()) == paged_kv.paged_cache_bytes(pools)
    assert paged_kv.unsupported_kinds(tm) == jpaged.unsupported_kinds(jm) == []


def test_preempt_resume_parity(setup):
    """A batch-class request preempted mid-decode by an interactive one
    (capacity 1) loses its state slot; the resume re-prefills prompt and
    generated tokens. Both engines give the same tokens, equal to
    uninterrupted generate."""
    _, jm, tm, params = setup
    prompts = _prompts([9, 6], jm.cfg.vocab, seed=13)
    je, te = _engines(jm, tm, params, max_batch=1, prefill_chunk=8,
                      page_size=4, max_seq_len=24)
    records = []
    for eng, mod in ((je, japi), (te, api)):
        finished = []
        eng.submit(mod.Request(prompt=prompts[0], max_new_tokens=7,
                               priority="batch"))
        for _ in range(4):
            finished.extend(eng.step())
        eng.submit(mod.Request(prompt=prompts[1], max_new_tokens=3,
                               priority="interactive"))
        while eng.scheduler.has_work():
            finished.extend(eng.step())
        records.append({r["rid"]: r for r in finished})
    jrec, trec = records
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions >= 1
    for rid, gen in ((0, 7), (1, 3)):
        np.testing.assert_array_equal(np.asarray(trec[rid]["tokens"]),
                                      np.asarray(jrec[rid]["tokens"]))
        assert trec[rid]["n_preempted"] == jrec[rid]["n_preempted"]
        want = generate(tm, params[1], torch.tensor(prompts[rid])[None], gen)[0]
        np.testing.assert_array_equal(np.asarray(trec[rid]["tokens"]),
                                      want.numpy())


def test_rejects_prefix_cache(setup):
    """Recurrent state is not position-sliceable: both engines refuse the
    prefix cache with the same error."""
    _, jm, tm, params = setup
    with pytest.raises(NotImplementedError, match="prefix-cache") as jerr:
        jengine.ServeEngine(jm, params[0], jengine.EngineConfig(prefix_cache=True))
    with pytest.raises(NotImplementedError, match="prefix-cache") as terr:
        ServeEngine(tm, params[1], EngineConfig(prefix_cache=True))
    assert str(terr.value) == str(jerr.value)
