"""The port's scheduler, prefix cache and page allocator against the JAX
package's: one random sequence of ``add``, ``next_tick`` and
``complete_tick`` fed to both must give equal ``TickPlan``s, page tables,
copy-on-write copies and finish records at every step (hypothesis sweeps
the sequences; prompts come from a 3-token vocabulary so that prefixes
collide and the radix tree is exercised, and the page pool is small enough
to force evictions and preemptions).

The reference's decode loop can crash under page pressure: the page growth
of one decoding slot may preempt a later decoding slot, and the loop then
grows the vacated slot (``AttributeError: 'NoneType' object has no
attribute 'pages'`` inside ``repro.serve.scheduler._ensure_pages``). The
port skips a slot that was preempted this way. From the tick where the
reference raises, the test drives the port alone and checks that it
completes the sequence and drains: no work left, every page free, every
request finished."""
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


def _reference_crashed(sj) -> bool:
    """Plan the reference's tick; True when it hits its decode-loop crash
    (a slot preempted by an earlier slot's page growth)."""
    try:
        sj._planned = sj.next_tick()
    except AttributeError as e:
        if "'NoneType' object has no attribute 'pages'" not in str(e):
            raise
        return True
    return False


def _tick(sj, st_, rng, finished):
    """One tick on both schedulers; returns False once the reference has
    crashed (the port then runs on alone, see ``_port_tick``)."""
    if _reference_crashed(sj):
        _port_tick(st_, rng, finished)
        return False
    pj, pt = sj._planned, st_.next_tick()
    assert _plan(pt) == _plan(pj)
    np.testing.assert_array_equal(st_.page_table(), sj.page_table())
    copies = sj.drain_copies()
    assert st_.drain_copies() == copies
    for src, _ in copies:                     # as the engines do
        sj.allocator.free([src])
        st_.allocator.free([src])
    if pj is None:
        return True
    sampled = rng.integers(0, 3, sj.capacity)
    recs = _records(st_.complete_tick(pt, sampled))
    assert recs == _records(sj.complete_tick(pj, sampled))
    finished.update(r[0] for r in recs)
    assert st_.n_preemptions == sj.n_preemptions
    assert st_.allocator.n_free == sj.allocator.n_free
    return True


def _port_tick(st_, rng, finished):
    pt = st_.next_tick()
    for src, _ in st_.drain_copies():
        st_.allocator.free([src])
    if pt is not None:
        recs = st_.complete_tick(pt, rng.integers(0, 3, st_.capacity))
        finished.update(int(r["rid"]) for r in recs)


OPS = st.lists(st.one_of(
    st.tuples(st.just("add"), st.integers(1, 14), st.integers(1, 6),
              st.sampled_from(["interactive", "standard", "batch"]),
              st.booleans()),
    st.tuples(st.just("tick"))), min_size=1, max_size=40)


# capacity 2, chunk 4, 7 pages, five short interactive requests: the
# reference crashes at its decode loop here, the port must drain
_CRASH = [("add", 10, 4, "interactive", False)] * 5


@hypothesis.settings(max_examples=40, deadline=None)
@hypothesis.given(ops=OPS, capacity=st.integers(1, 3),
                  chunk=st.sampled_from([4, 8]),
                  n_pages=st.integers(6, 14),
                  jumbo=st.booleans(), cached=st.booleans(),
                  seed=st.integers(0, 2**16))
@hypothesis.example(ops=_CRASH, capacity=2, chunk=4, n_pages=7, jumbo=False,
                    cached=False, seed=0)
def test_scheduler_matches_jax(ops, capacity, chunk, n_pages, jumbo, cached,
                               seed):
    max_pages = 5                              # 20 tokens per request
    sj, st_ = _pair(capacity, chunk, n_pages, max_pages,
                    2 * chunk if jumbo else None, cached)
    rng = np.random.default_rng(seed)
    rid = 0
    both = True                                # the reference still runs
    finished: set = set()
    for op in ops:
        if op[0] == "add":
            _, plen, gen, pri, eos = op
            plen = min(plen, max_pages * PS - gen)
            prompt = rng.integers(0, 3, plen).astype(np.int32)
            kw = dict(rid=rid, prompt=prompt, max_new_tokens=gen,
                      eos_id=1 if eos else None, priority=pri)
            st_.add(scheduler.Request(**kw))
            if both:
                sj.add(jsched.Request(**kw))
            rid += 1
        elif both:
            both = _tick(sj, st_, rng, finished)
        else:
            _port_tick(st_, rng, finished)
    for _ in range(400):
        if both and not (sj.has_work() or st_.has_work()):
            break
        if not both and not st_.has_work():
            break
        if both:
            both = _tick(sj, st_, rng, finished)
        else:
            _port_tick(st_, rng, finished)
    assert not st_.has_work()
    assert finished == set(range(rid))
    if both:
        assert not sj.has_work()
        if cached:
            assert st_.prefix_cache.cached_pages() == \
                sj.prefix_cache.cached_pages()
            assert st_.prefix_cache.hit_rate == sj.prefix_cache.hit_rate
    held = len(st_.prefix_cache.cached_pages()) if cached else 0
    assert st_.allocator.n_free + held == n_pages - 1


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
