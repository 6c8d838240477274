"""The port's scheduler, prefix cache and page allocator against the JAX
package's: one random sequence of ``add``, ``next_tick`` and
``complete_tick`` fed to both must give equal ``TickPlan``s, page tables,
copy-on-write copies and finish records at every step (hypothesis sweeps
the sequences; prompts come from a 3-token vocabulary so that prefixes
collide and the radix tree is exercised, and the page pool is small enough
to force evictions and preemptions)."""
import hypothesis
import hypothesis.strategies as st
import numpy as np
import pytest

from repro.serve import paged_kv as jpaged
from repro.serve import prefix_cache as jprefix
from repro.serve import scheduler as jsched
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve import paged_kv, prefix_cache, scheduler

PS = 4


def _pair(capacity, chunk, n_pages, max_pages, first_chunk, cached):
    out = []
    for pk, pc, sc in ((jpaged, jprefix, jsched),
                       (paged_kv, prefix_cache, scheduler)):
        alloc = pk.PageAllocator(n_pages)
        cache = pc.PrefixCache(alloc, PS) if cached else None
        out.append(sc.Scheduler(capacity=capacity, prefill_chunk=chunk,
                                allocator=alloc, page_size=PS,
                                max_pages=max_pages, first_chunk=first_chunk,
                                prefix_cache=cache))
    return out


def _plan(p):
    if p is None:
        return None
    return (p.width, p.tokens.tolist(), p.start_pos.tolist(),
            p.n_tokens.tolist(), list(p.samples))


def _records(recs):
    keys = ("rid", "slot", "n_prompt", "n_generated", "priority", "n_cached",
            "n_preempted")
    return [tuple(r[k] for k in keys) + (r["tokens"].tolist(),) for r in recs]


def _tick(sj, st_, rng):
    pj, pt = sj.next_tick(), st_.next_tick()
    assert _plan(pt) == _plan(pj)
    np.testing.assert_array_equal(st_.page_table(), sj.page_table())
    copies = sj.drain_copies()
    assert st_.drain_copies() == copies
    for src, _ in copies:                     # as the engines do
        sj.allocator.free([src])
        st_.allocator.free([src])
    if pj is None:
        return
    sampled = rng.integers(0, 3, sj.capacity)
    assert _records(st_.complete_tick(pt, sampled)) == \
        _records(sj.complete_tick(pj, sampled))
    assert st_.n_preemptions == sj.n_preemptions
    assert st_.allocator.n_free == sj.allocator.n_free


OPS = st.lists(st.one_of(
    st.tuples(st.just("add"), st.integers(1, 14), st.integers(1, 6),
              st.sampled_from(["interactive", "standard", "batch"]),
              st.booleans()),
    st.tuples(st.just("tick"))), min_size=1, max_size=40)


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(ops=OPS, capacity=st.integers(1, 3),
                  chunk=st.sampled_from([4, 8]),
                  n_pages=st.integers(6, 14),
                  jumbo=st.booleans(), cached=st.booleans(),
                  seed=st.integers(0, 2**16))
def test_scheduler_matches_jax(ops, capacity, chunk, n_pages, jumbo, cached,
                               seed):
    max_pages = 5                              # 20 tokens per request
    sj, st_ = _pair(capacity, chunk, n_pages, max_pages,
                    2 * chunk if jumbo else None, cached)
    rng = np.random.default_rng(seed)
    rid = 0
    for op in ops:
        if op[0] == "add":
            _, plen, gen, pri, eos = op
            plen = min(plen, max_pages * PS - gen)
            prompt = rng.integers(0, 3, plen).astype(np.int32)
            kw = dict(rid=rid, prompt=prompt, max_new_tokens=gen,
                      eos_id=1 if eos else None, priority=pri)
            sj.add(jsched.Request(**kw))
            st_.add(scheduler.Request(**kw))
            rid += 1
        else:
            _tick(sj, st_, rng)
    for _ in range(400):
        if not (sj.has_work() or st_.has_work()):
            break
        _tick(sj, st_, rng)
    assert not st_.has_work() and not sj.has_work()
    if cached:
        assert st_.prefix_cache.cached_pages() == sj.prefix_cache.cached_pages()
        assert st_.prefix_cache.hit_rate == sj.prefix_cache.hit_rate


def test_allocator_refcounts_and_errors():
    m = MetricsRegistry()
    a = paged_kv.PageAllocator(8, metrics=m)
    got = a.alloc(3)
    assert got == [1, 2, 3] and a.n_free == 4
    a.incref(2)
    a.free([2])
    assert a.refcount(2) == 1 and a.n_free == 4
    a.free(got)
    assert a.n_free == 7
    assert m.get("repro_page_frees_total").value() == 3
    with pytest.raises(MemoryError):
        a.alloc(8)
    with pytest.raises(ValueError, match="double free"):
        a.free([1])
    with pytest.raises(ValueError, match="not an allocatable"):
        a.free([0])
    with pytest.raises(ValueError):
        paged_kv.PageAllocator(1)
    assert paged_kv.pages_for(17, 4) == jpaged.pages_for(17, 4) == 5
