"""The port's multi-replica router against ``repro.serve.router``.

Dispatch: the fake-engine cases of ``tests/test_router.py`` run against
both routers side by side, on the same prompts and the same replica states
(inflight, reserved pages, failed): affinity keys, HRW owners before and
after a replica dies, least-loaded ties, round-robin over the healthy
replicas, backpressure's ``None`` and ``ReplicaFailed`` must be the
reference's choices.

Serving: on reduced smollm-360m with BlockCSR weights carried across from
the JAX package, a 2-replica fleet whose replica 0 fails after 4 tokens
streams every request's tokens equal to the JAX package's ``generate``,
with contiguous stream indices; requests sharing a prefix all land on one
replica and hit its prefix cache; a served router, once dropped, frees
its engines at once. A GPU-marked case runs 2 replicas on 2 streams of the
card.
"""
import asyncio
import gc
import types
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.models.model_zoo import build as jax_build
from repro.serve import engine as jengine
from repro.serve import router as jrouter
from repro.serve import step as jstep
from repro.serve.api import Request as JRequest
from repro.sparse.compress import (CompressionPlan, compress_params,
                                   prune_blocks_for_plan)
from repro_torch.models.model_zoo import build
from repro_torch.serve import engine, router
from repro_torch.serve.api import ApiValidationError, Request
from repro_torch.serve.step import generate
from torch_parity import to_port

GEN = 6


# -- fakes: dispatch logic without an engine ---------------------------------

class _FakeEngine:
    """Just enough surface for dispatch: config and load counters."""

    def __init__(self, config):
        self.config = config
        self.scheduler = types.SimpleNamespace(
            n_reserved_pages=0, n_preemptions=0, has_work=lambda: False)
        self.prefix_cache = None
        self.n_ticks = 0


def _routers(n=2, policy="prefix", **kw):
    """(port router, reference router) over fake engines of one config."""
    cfg = dict(max_batch=4, prefill_chunk=8, page_size=4, max_seq_len=64)
    return (router.Router([_FakeEngine(engine.EngineConfig(**cfg))
                           for _ in range(n)], policy=policy, **kw),
            jrouter.Router([_FakeEngine(jengine.EngineConfig(**cfg))
                            for _ in range(n)], policy=policy, **kw))


def _prompt(seed, length):
    rng = np.random.default_rng(seed)
    return tuple(int(t) for t in rng.integers(0, 1000, size=length))


def _choose(r, prompt):
    req = (Request if isinstance(r, router.Router) else JRequest)(
        prompt=prompt, max_new_tokens=4)
    try:
        return r._choose(req)
    except (router.ReplicaFailed, jrouter.ReplicaFailed) as e:
        return type(e).__name__


def _set_state(routers, inflight=(), pages=(), failed=()):
    for r in routers:
        for i, rep in enumerate(r.replicas):
            rep.inflight = inflight[i] if inflight else 0
            rep.engine.scheduler.n_reserved_pages = pages[i] if pages else 0
            rep.failed = i in failed


def test_router_validates_construction():
    with pytest.raises(ApiValidationError, match="at least one replica"):
        router.Router([])
    with pytest.raises(ApiValidationError, match="route policy"):
        _routers(policy="bogus")
    assert router.ROUTE_POLICIES == jrouter.ROUTE_POLICIES


def test_affinity_keys_match():
    t, j = _routers()
    for seed, n in [(0, 3), (0, 4), (1, 40), (2, 16), (3, 17), (4, 1),
                    (5, 15), (6, 64)]:
        p = _prompt(seed, n)
        assert t._affinity_key(p) == j._affinity_key(p), n
    long = _prompt(1, 40)
    assert t._affinity_key(long[:16] + _prompt(2, 10)) == \
        t._affinity_key(long)


def test_hrw_owners_match_and_remap_only_the_dead():
    t, j = _routers(n=4)
    keys = [t._affinity_key(_prompt(seed, 16)) for seed in range(60)]
    for cands in ([0, 1, 2, 3], [3, 1, 0, 2], [0, 1, 3], [2], [1, 3]):
        owners = [t._rendezvous(k, cands) for k in keys]
        assert owners == [j._rendezvous(k, cands) for k in keys], cands
    before = [t._rendezvous(k, [0, 1, 2, 3]) for k in keys]
    assert set(before) == {0, 1, 2, 3}
    _set_state((t, j), failed=(2,))
    after = [_choose(t, _prompt(seed, 16)) for seed in range(60)]
    assert after == [_choose(j, _prompt(seed, 16)) for seed in range(60)]
    for b, a in zip(before, after):
        assert a == b if b != 2 else a != 2


@pytest.mark.parametrize("policy", router.ROUTE_POLICIES)
def test_choices_match_over_random_states(policy):
    """Random inflight counts (up to backpressure), reserved pages and
    failed replicas; the same sequence of prompts (some shorter than a
    page) through both routers gives the same choices, None and
    ReplicaFailed included."""
    t, j = _routers(n=4, policy=policy)
    rng = np.random.default_rng(len(policy))
    seen = set()
    for case in range(150):
        failed = tuple(i for i in range(4) if rng.random() < 0.25)
        _set_state((t, j),
                   inflight=rng.integers(0, t.max_inflight + 1, 4).tolist(),
                   pages=rng.integers(0, 40, 4).tolist(), failed=failed)
        p = _prompt(case, int(rng.integers(1, 30)))
        got, want = _choose(t, p), _choose(j, p)
        assert got == want, (case, failed)
        seen.add(got if not isinstance(got, int) else "replica")
    assert {"replica", None, "ReplicaFailed"} <= seen


def test_short_prompt_and_least_loaded_ties():
    for policy in ("prefix", "least-loaded"):
        routers = _routers(policy=policy)
        short = _prompt(0, 3)
        for state, want in [({}, 0), ({"inflight": (1, 0)}, 1),
                            ({"pages": (8, 0)}, 1),
                            ({"inflight": (0, 1), "pages": (8, 0)}, 0)]:
            _set_state(routers, **state)
            prompt = short if policy == "prefix" else _prompt(0, 20)
            assert [_choose(r, prompt) for r in routers] == [want] * 2


def test_round_robin_cycles_and_skips_failed():
    routers = _routers(n=3, policy="round-robin")
    for r in routers:
        assert [_choose(r, _prompt(0, 20)) for _ in range(6)] == \
            [0, 1, 2, 0, 1, 2]
    _set_state(routers, failed=(1,))
    seqs = [[_choose(r, _prompt(0, 20)) for _ in range(4)] for r in routers]
    assert seqs[0] == seqs[1] and set(seqs[0]) == {0, 2}


def test_backpressure_waits_for_the_affine_replica():
    routers = _routers()
    p = _prompt(9, 20)
    i = _choose(routers[0], p)
    assert _choose(routers[1], p) == i
    inflight = [0, 0]
    inflight[i] = routers[0].max_inflight
    _set_state(routers, inflight=inflight)
    assert [_choose(r, p) for r in routers] == [None, None]
    _set_state(routers)
    assert [_choose(r, p) for r in routers] == [i, i]


def test_all_replicas_failed_raises():
    routers = _routers()
    _set_state(routers, failed=(0, 1))
    assert [_choose(r, _prompt(0, 20)) for r in routers] == \
        ["ReplicaFailed"] * 2


# -- integration: real engines on bridged weights ----------------------------

@pytest.fixture(scope="module")
def models():
    return (jax_build("smollm-360m", reduced=True),
            build("smollm-360m", reduced=True, device="cpu"))


@pytest.fixture(scope="module")
def params(models):
    jm, _ = models
    plan = CompressionPlan(block=(8, 64), min_sparsity=0.5)
    cp = compress_params(prune_blocks_for_plan(
        jm.init(jax.random.PRNGKey(0)), plan, 0.85), plan)
    return cp, to_port(cp)


def _jax_tokens(jm, jp, prompt, gen=GEN) -> np.ndarray:
    return np.asarray(jstep.generate(jm, jp, prompt[None, :], gen))[0]


def _prompts(lens, vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def test_router_failover_matches_jax_generate(models, params):
    """2 replicas, replica 0 failed once it has streamed 4 tokens: every
    request, the re-dispatched ones included, streams the JAX package's
    ``generate`` tokens, with indices contiguous across the move."""
    jm, tm = models
    jp, tp = params
    config = engine.EngineConfig(max_batch=4, prefill_chunk=8, page_size=4,
                                 max_seq_len=32)
    fleet = router.Router.build(tm, tp, config, 2, policy="least-loaded")
    prompts = _prompts([5, 12, 3, 12, 8, 6], tm.cfg.vocab)
    events = []

    async def flow():
        await fleet.start()
        fleet.fail_replica_after(0, 4)
        futs = [await fleet.submit(Request(prompt=p, max_new_tokens=GEN),
                                   stream=events.append) for p in prompts]
        completions = await asyncio.gather(*futs)
        await fleet.stop()
        return completions

    completions = asyncio.run(flow())
    stats = fleet.fleet_stats(completions=completions)
    assert stats["n_failed_replicas"] == 1 and stats["n_redispatched"] >= 1
    assert not any(rep.thread.is_alive() for rep in fleet.replicas)
    by_rid = {c.request_id: c for c in completions}
    assert sorted(by_rid) == list(range(len(prompts)))
    for rid, p in enumerate(prompts):
        c = by_rid[rid]
        np.testing.assert_array_equal(
            c.token_ids, _jax_tokens(jm, jp, p),
            err_msg=f"request {rid} (n_redispatched={c.n_redispatched})")
        evs = [e for e in events if e.request_id == rid]
        assert [e.index for e in evs] == list(range(GEN))
        assert [e.token for e in evs] == list(c.tokens)
        assert [e.done for e in evs] == [False] * (GEN - 1) + [True]
        assert c.replica == 1 or c.n_redispatched == 0
    prom = fleet.to_prometheus()
    assert "repro_router_failovers_total 1" in prom
    assert 'replica="1"' in prom and "repro_engine_ticks_total" in prom


def test_router_prefix_affinity_lands_on_one_warm_replica(models, params):
    jm, tm = models
    jp, tp = params
    config = engine.EngineConfig(max_batch=4, prefill_chunk=8, page_size=4,
                                 max_seq_len=32, prefix_cache=True)
    fleet = router.Router.build(tm, tp, config, 2, policy="prefix")
    shared = _prompts([16], tm.cfg.vocab, seed=3)[0]   # the affinity window
    prompts = [np.concatenate([shared, t])
               for t in _prompts([4] * 6, tm.cfg.vocab, seed=11)]
    out = fleet.serve([(p, GEN) for p in prompts])
    per = {r["replica"]: r for r in out["stats"]["per_replica"]}
    assert sorted(r["n_requests"] for r in per.values()) == [0, 6]
    warm = max(per.values(), key=lambda r: r["n_requests"])
    assert warm["prefix_hit_rate"] > 0
    assert out["stats"]["n_cached_tokens"] > 0
    for rid, p in enumerate(prompts):
        np.testing.assert_array_equal(out["results"][rid],
                                      _jax_tokens(jm, jp, p),
                                      err_msg=f"request {rid}")


def test_a_served_router_frees_its_fleet(models, params):
    """Once ``serve`` has returned, after a failover too, dropping the
    router frees its engines, and with them their pools, at once: no
    reference cycle leaves the fleet to the cyclic garbage collector."""
    _, tm = models
    config = engine.EngineConfig(max_batch=4, prefill_chunk=8, page_size=4,
                                 max_seq_len=32)
    fleet = router.Router.build(tm, params[1], config, 2,
                                policy="least-loaded")
    fleet.fail_replica_after(0, 2)
    out = fleet.serve([(p, GEN) for p in _prompts([5, 12, 3, 8],
                                                  tm.cfg.vocab)])
    assert out["stats"]["n_failed_replicas"] == 1
    engines = [weakref.ref(rep.engine) for rep in fleet.replicas]
    del out
    gc.collect()
    gc.disable()
    try:
        del fleet
        assert [e() for e in engines] == [None, None]
    finally:
        gc.enable()


@pytest.mark.parametrize("message", [
    "worker fault", "CUDA error: an illegal memory access was encountered"])
def test_worker_error_fails_over_or_fails_the_fleet(models, params, message,
                                                    caplog):
    """A worker that raises is logged with its traceback. Any error but a
    CUDA one fails its replica and its requests resume on the other, with
    ``generate``'s tokens; a CUDA error (which may poison the card for
    every replica) fails the whole fleet and ``serve`` raises."""
    jm, tm = models
    jp, tp = params
    config = engine.EngineConfig(max_batch=4, prefill_chunk=8, page_size=4,
                                 max_seq_len=32)
    fleet = router.Router.build(tm, tp, config, 2, policy="round-robin")
    eng = fleet.replicas[0].engine
    step, calls = eng.step, []

    def failing_step():
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError(message)
        return step()

    eng.step = failing_step
    prompts = _prompts([5, 12, 8, 6], tm.cfg.vocab)
    if message.startswith("CUDA"):
        with pytest.raises(router.ReplicaFailed, match="CUDA error"):
            fleet.serve([(p, GEN) for p in prompts])
        assert all(rep.failed for rep in fleet.replicas)
    else:
        out = fleet.serve([(p, GEN) for p in prompts])
        s = out["stats"]
        assert s["n_failed_replicas"] == 1 and s["n_redispatched"] >= 1
        for rid, p in enumerate(prompts):
            np.testing.assert_array_equal(out["results"][rid],
                                          _jax_tokens(jm, jp, p))
    assert not any(rep.thread.is_alive() for rep in fleet.replicas)
    assert "replica 0: worker raised" in caplog.text
    assert message in caplog.text


@pytest.mark.gpu
def test_cuda_two_replicas_on_two_streams(models, params):
    """On the card: 2 replicas, each on its own stream, give ``generate``'s
    tokens, and building them allocates their pools only (the weights
    exist once)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    dev = torch.device("cuda")
    tm = build("smollm-360m", reduced=True, device=dev)
    tp = to_port(params[0], dev)
    config = engine.EngineConfig(max_batch=4, prefill_chunk=8, page_size=4,
                                 max_seq_len=32)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    fleet = router.Router.build(tm, tp, config, 2, policy="round-robin")
    grown = torch.cuda.memory_allocated() - before
    pool = fleet.replicas[0].engine.pool_bytes
    assert grown <= 2 * (pool["kv_page_bytes"] + pool["state_slot_bytes"]) \
        + (1 << 20)
    prompts = _prompts([5, 12, 3, 12, 8, 6], tm.cfg.vocab)
    out = fleet.serve([(p, GEN) for p in prompts])
    streams = {rep.stream for rep in fleet.replicas}
    assert len(streams) == 2 and None not in streams
    assert all(r["n_requests"] == 3 for r in out["stats"]["per_replica"])
    for rid, p in enumerate(prompts):
        want = generate(tm, tp, torch.as_tensor(p, device=dev)[None], GEN)[0]
        np.testing.assert_array_equal(out["results"][rid], want.cpu().numpy())
