"""The port's continuous-batching engine against ``repro.serve.engine``.

Both engines serve the same weights (carried across as numpy) and the same
request mixes as ``tests/test_serve_engine.py``: concurrent mixed-length
requests from dense, BlockCSR and PaletteBCSR weights, chunked prefill
interleaved with decode, the jumbo ``first_chunk``, page-pressure
preemption, a mid-page prefix-cache hit (copy-on-write boundary page),
priority preempt-and-resume, and the paged kernel backend ('cuda', whose
plain version runs on the CPU, against JAX's 'pallas' in interpret mode)
with KV splits. Greedy tokens must be identical, and so must the run's
``n_ticks``, ``n_prefill_chunks``, ``n_preemptions``, ``prefix_hit_rate``
and ``tick_widths``. The engines' greedy tokens also equal the port's own
``generate``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.model_zoo import build as jax_build
from repro.serve import api as japi
from repro.serve import engine as jengine
from repro.sparse.compress import (CompressionPlan, compress_params,
                                   prune_blocks_for_plan, quantize_compressed)
from repro_torch.models.model_zoo import build
from repro_torch.serve import api
from repro_torch.serve.engine import EngineConfig, ServeEngine
from repro_torch.serve.step import generate
from torch_parity import to_port

GEN = 5
STATS = ("n_ticks", "n_prefill_chunks", "n_preemptions", "prefix_hit_rate",
         "n_requests", "n_generated", "n_prompt", "n_cached_tokens")


@pytest.fixture(scope="module")
def models():
    return (jax_build("smollm-360m", reduced=True),
            build("smollm-360m", reduced=True, device="cpu"))


@pytest.fixture(scope="module")
def params_by_format(models):
    jm, _ = models
    params = jm.init(jax.random.PRNGKey(0))
    plan = CompressionPlan(block=(8, 64), min_sparsity=0.5)
    pruned = prune_blocks_for_plan(params, plan, 0.85)
    cp = compress_params(pruned, plan)
    jax_params = {"dense": pruned, "bcsr": cp,
                  "palette8": quantize_compressed(cp, bits=8)}
    return {k: (v, to_port(v)) for k, v in jax_params.items()}


def _prompts(lens, vocab, seed=7):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).astype(np.int32) for n in lens]


def _engines(models, params, jax_backend="ref", **kw):
    jm, tm = models
    jp, tp = params
    je = jengine.ServeEngine(jm, jp, jengine.EngineConfig(
        attn_backend=jax_backend, **kw))
    te = ServeEngine(tm, tp, EngineConfig(
        attn_backend="cuda" if jax_backend == "pallas" else "ref", **kw))
    return je, te


def _check_run(je, te, out_j, out_t):
    assert set(out_t["results"]) == set(out_j["results"])
    for rid, want in out_j["results"].items():
        np.testing.assert_array_equal(np.asarray(out_t["results"][rid]),
                                      np.asarray(want), err_msg=f"rid {rid}")
    for key in STATS:
        assert out_t["stats"][key] == out_j["stats"][key], key
    assert te.tick_widths == je.tick_widths
    comp_j = {c.request_id: c for c in out_j["completions"]}
    for c in out_t["completions"]:
        assert (c.n_cached, c.n_preempted, c.priority) == (
            comp_j[c.request_id].n_cached, comp_j[c.request_id].n_preempted,
            comp_j[c.request_id].priority)


def _run_both(models, params, prompts, gen=GEN, priorities=None,
              jax_backend="ref", **kw):
    je, te = _engines(models, params, jax_backend, **kw)
    pri = priorities or ["standard"] * len(prompts)
    out_j = je.run([japi.Request(prompt=p, max_new_tokens=gen, priority=r)
                    for p, r in zip(prompts, pri)])
    out_t = te.run([api.Request(prompt=p, max_new_tokens=gen, priority=r)
                    for p, r in zip(prompts, pri)])
    _check_run(je, te, out_j, out_t)
    return je, te, out_t


def _check_generate(models, params, prompts, results, gen=GEN):
    _, tm = models
    for rid, p in enumerate(prompts):
        want = generate(tm, params[1], torch.tensor(p)[None], gen)[0]
        np.testing.assert_array_equal(np.asarray(results[rid]), want.numpy())


@pytest.mark.parametrize("fmt", ["dense", "bcsr"])
def test_engine_token_parity(models, params_by_format, fmt):
    """4 concurrent mixed-length requests."""
    prompts = _prompts([5, 12, 3, 12], models[0].cfg.vocab)
    _, _, out = _run_both(models, params_by_format[fmt], prompts,
                          max_batch=4, prefill_chunk=8, page_size=4,
                          max_seq_len=12 + GEN)
    _check_generate(models, params_by_format[fmt], prompts, out["results"])


def test_engine_eight_concurrent_palette(models, params_by_format):
    """8 concurrent requests from PaletteBCSR weights, prompts longer than
    the prefill chunk included."""
    prompts = _prompts([5, 12, 3, 20, 5, 12, 3, 20], models[0].cfg.vocab)
    _, _, out = _run_both(models, params_by_format["palette8"], prompts,
                          max_batch=8, prefill_chunk=8, page_size=4,
                          max_seq_len=20 + GEN)
    assert out["stats"]["n_prefill_chunks"] >= 2 * 3 + 6


def test_chunked_prefill_interleaves_with_decode(models, params_by_format):
    prompts = _prompts([3, 20], models[0].cfg.vocab)
    je, te, _ = _run_both(models, params_by_format["bcsr"], prompts,
                          max_batch=2, prefill_chunk=8, page_size=4,
                          max_seq_len=32)
    assert te.scheduler.n_prefill_chunks == 1 + 3
    assert te.n_ticks < (1 + GEN) + (3 + GEN)


def test_engine_jumbo_first_chunk(models, params_by_format):
    prompts = _prompts([20, 3], models[0].cfg.vocab)
    _, te, _ = _run_both(models, params_by_format["dense"], prompts,
                         max_batch=2, prefill_chunk=8, page_size=4,
                         max_seq_len=32, first_chunk=16)
    assert te.tick_widths == {1, 8, 16}


def test_engine_page_pressure_preempts(models, params_by_format):
    """Pages for about two requests in flight: the youngest is preempted
    and resumed (prompt + generated re-prefilled) in both engines alike."""
    prompts = _prompts([5, 9, 5, 9], models[0].cfg.vocab)
    _, te, out = _run_both(models, params_by_format["bcsr"], prompts,
                           max_batch=4, prefill_chunk=8, page_size=4,
                           max_seq_len=16, n_pages=9)
    assert out["stats"]["n_preemptions"] >= 1
    assert te.allocator.n_free == 8
    _check_generate(models, params_by_format["bcsr"], prompts, out["results"])


@pytest.mark.parametrize("jumbo", [False, True])
def test_prefix_cache_mid_page_hit(models, params_by_format, jumbo):
    """A cold request fills the radix tree; a warm wave sharing its
    14-token prefix (not page-aligned: the boundary page is copied on
    write) maps the cached pages. Tokens and hit rates equal JAX's."""
    vocab = models[0].cfg.vocab
    shared = _prompts([14], vocab, seed=23)[0]
    prompts = [np.concatenate([shared, t])
               for t in _prompts([3, 2, 5], vocab, seed=29)]
    kw = dict(max_batch=2, prefill_chunk=8, page_size=4, max_seq_len=24,
              first_chunk=16 if jumbo else None, prefix_cache=True)
    je, te = _engines(models, params_by_format["bcsr"], **kw)
    for wave in (prompts[:1], prompts[1:]):
        out_j = je.run([japi.Request(prompt=p, max_new_tokens=GEN)
                        for p in wave])
        out_t = te.run([api.Request(prompt=p, max_new_tokens=GEN)
                        for p in wave])
        _check_run(je, te, out_j, out_t)
    assert out_t["stats"]["n_cached_tokens"] >= 2 * 12
    assert te.scheduler._m_cow.value() >= 1
    assert te.prefix_cache.cached_pages() == je.prefix_cache.cached_pages()


def test_preempt_resume_by_priority(models, params_by_format):
    """A batch-class request is preempted mid-decode by an interactive
    arrival (capacity 1) and resumed; both engines, stepped in lockstep,
    finish the same requests at the same ticks with the same tokens."""
    prompts = _prompts([9, 7], models[0].cfg.vocab, seed=31)
    je, te = _engines(models, params_by_format["bcsr"], max_batch=1,
                      prefill_chunk=8, page_size=4, max_seq_len=24,
                      prefix_cache=True)
    done_j, done_t = [], []

    def submit(prompt, gen, pri):
        je.submit(japi.Request(prompt=prompt, max_new_tokens=gen,
                               priority=pri))
        te.submit(api.Request(prompt=prompt, max_new_tokens=gen,
                              priority=pri))

    def tick():
        done_j.append([(r["rid"], r["tokens"].tolist()) for r in je.step()])
        done_t.append([(r["rid"], r["tokens"].tolist()) for r in te.step()])

    submit(prompts[0], 8, "batch")
    for _ in range(4):
        tick()
    submit(prompts[1], 4, "interactive")
    while je.scheduler.has_work() or te.scheduler.has_work():
        tick()
    assert done_t == done_j
    assert te.scheduler.n_preemptions == je.scheduler.n_preemptions >= 1
    assert te.allocator.n_free == je.allocator.n_free


@pytest.mark.parametrize("splits", [1, 2])
def test_kernel_backend_parity(models, params_by_format, splits):
    """The engine on the paged kernel backend ('cuda': its plain version on
    the CPU) against JAX's 'pallas' backend in interpret mode."""
    prompts = _prompts([5, 12, 3], models[0].cfg.vocab)
    _, _, out = _run_both(models, params_by_format["bcsr"], prompts,
                          jax_backend="pallas", max_batch=3, prefill_chunk=8,
                          page_size=4, max_seq_len=24, kv_splits=splits)
    _check_generate(models, params_by_format["bcsr"], prompts, out["results"])


def test_streaming_events_and_eos(models, params_by_format):
    prompt = _prompts([6], models[0].cfg.vocab)[0]
    _, tm = models
    tp = params_by_format["bcsr"][1]
    want = generate(tm, tp, torch.tensor(prompt)[None], GEN)[0].tolist()
    events = []
    eng = ServeEngine(tm, tp, EngineConfig(max_batch=2, prefill_chunk=8,
                                           page_size=4, max_seq_len=16))
    rid = eng.submit(api.Request(prompt=prompt, max_new_tokens=GEN),
                     stream=events.append)
    eng.run()
    assert [e.token for e in events] == want
    assert [e.index for e in events] == list(range(GEN))
    assert [e.done for e in events] == [False] * (GEN - 1) + [True]
    assert all(e.request_id == rid for e in events)
    eos = want[2]
    out = eng.run([api.Request(prompt=prompt, max_new_tokens=GEN,
                               eos_id=eos)])
    (toks,) = out["results"].values()
    assert toks.tolist() == want[:want.index(eos) + 1]
    assert eng.allocator.n_free == eng.config.total_pages - 1


def test_engine_config_round_trip_and_validation(models, params_by_format):
    cfg = EngineConfig(max_batch=3, first_chunk=64, kv_splits=2,
                       class_shares=((0, 2.0), (2, 0.5)),
                       sampling=api.SamplingParams(temperature=0.5))
    assert EngineConfig.from_json(cfg.to_json()) == cfg
    want = jengine.EngineConfig(max_batch=3, first_chunk=64, kv_splits=2,
                                class_shares=((0, 2.0), (2, 0.5)),
                                sampling=japi.SamplingParams(temperature=0.5))
    assert cfg.to_json() == want.to_json()
    with pytest.raises(api.ApiValidationError, match="attn_backend"):
        EngineConfig(attn_backend="pallas")
    with pytest.raises(api.ApiValidationError, match="did you mean"):
        EngineConfig.from_json({"max_bach": 2})
    eng = ServeEngine(models[1], params_by_format["dense"][1], EngineConfig())
    with pytest.raises(api.ApiValidationError, match="engine-wide"):
        eng.submit(api.Request(prompt=[1, 2], max_new_tokens=2,
                               sampling=api.SamplingParams(temperature=1.0)))
