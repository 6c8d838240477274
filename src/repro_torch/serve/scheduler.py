"""The port's copy of ``repro.serve.scheduler`` (host-side, numpy only).

Production request scheduler for the continuous-batching engine:
priority classes with preempt-and-requeue, optimistic admission with lazy
page allocation, radix-tree prefix-cache integration, SLO-aware per-class
token-budget shares, chunked prefill interleaved with decode.

Scheduling is entirely host-side and shape-stable: every tick produces a
``TickPlan`` whose arrays are ``(capacity, width)`` with ``width`` one of 1
(pure-decode tick), ``prefill_chunk`` (a tick that advances at least one
prompt) or the optional ``first_chunk`` jumbo width — request churn,
preemption, and prefix-cache hits only ever change array *data*, so the
engine's jitted mixed step compiles at most three times.

The request lifecycle (the preemption state machine):

    WAITING --admit--> PREFILLING --prompt done--> DECODING --EOS/max--> DONE
       ^                   |                           |
       '---- preempt ------'----------ditto------------'

* **Admission is optimistic, by priority class.** Requests carry an int
  ``priority`` (0 = most important; see ``PRIORITY_CLASSES``). A waiting
  request is admitted as soon as a slot is free — no worst-case page
  reservation. Pages are allocated lazily, tick by tick, for the tokens
  actually being written. Within a class admission is FCFS; across
  classes, more important first. If every slot is busy and the head of a
  waiting class is strictly more important than some running request, the
  least-important (then youngest) running slot is preempted to make room.
* **Preempt-and-requeue.** A preempted request's pages are released (its
  prefix-cached pages survive in the radix tree — the tree holds its own
  reference), its generated-so-far tokens are kept, and it re-enters the
  FRONT of its class queue. On re-admission its prompt *plus* the tokens
  it already generated are re-prefilled as one sequence ("seq"); with the
  prefix cache on, the prompt part is typically still cached, so resume
  costs only the generated suffix. Greedy decoding makes the resumed
  request's remaining tokens match the uninterrupted run token-for-token.
* **Page-shortfall preemption.** When a tick needs pages and the free
  list is dry, cold prefix-cache pages are evicted first (LRU leaves the
  tree is the sole owner of); if still short, the least-important
  youngest page-holding slot is preempted — possibly the needy slot
  itself (its grant is then deferred to a later tick).
* **Decode first.** Every running slot in the decode phase gets its 1
  token each tick, off the top of the token budget, most-important first.
* **SLO-aware prefill shares.** The remaining budget is split across the
  priority classes that have prefill demand, proportionally to
  ``class_shares`` (default: class c gets weight 2^-c), leftover spilling
  to the most important class — so batch-class prefill can never starve
  interactive TTFT, but still makes progress under load.
* **Prefix cache.** At admission the request's seq is matched against the
  radix tree: fully cached pages are mapped into the page table (shared,
  refcounted), a mid-page match becomes a COW copy (``drain_copies``),
  and ``n_prefilled`` starts at the cached length. At prompt completion
  the request's immutable prompt pages are inserted for future requests.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve.api import (PRIORITY_CLASSES,  # noqa: F401 (re-export)
                                   resolve_priority)
from repro_torch.serve.paged_kv import PageAllocator, pages_for
from repro_torch.serve.prefix_cache import PrefixCache


@dataclasses.dataclass
class Request:
    """One serving request. ``prompt`` is a 1D int32 token array;
    ``stream`` (optional) is called as ``stream(rid, token, done)`` for
    every generated token; ``priority`` is the scheduling class
    (0 = most important — see ``PRIORITY_CLASSES``)."""
    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    eos_id: Optional[int] = None
    stream: Optional[Callable] = None
    priority: int = 1


@dataclasses.dataclass
class _WaitEntry:
    """A queued (possibly preempted) request and the state that survives
    preemption: tokens generated so far, TTFT stamp, preemption count."""
    req: Request
    t_submit: float
    generated: list = dataclasses.field(default_factory=list)
    n_preempted: int = 0
    t_first: Optional[float] = None


@dataclasses.dataclass
class _Slot:
    """Serving state of one admitted request (one engine slot). ``seq`` is
    the token sequence being prefilled: the prompt, plus — after a
    preemption — the tokens generated before it (regenerating the KV the
    preemption dropped)."""
    req: Request
    seq: np.ndarray
    pages: list
    admit_seq: int                      # admission stamp (victim tiebreak)
    n_cached: int = 0                   # seq tokens served by prefix cache
    n_prefilled: int = 0                # seq tokens done (incl. cached)
    generated: Optional[list] = None    # all generated (incl. pre-preempt)
    n_gen_at_admit: int = 0
    n_preempted: int = 0
    t_submit: float = 0.0
    t_admit: float = 0.0
    t_first: Optional[float] = None

    def __post_init__(self):
        if self.generated is None:
            self.generated = []

    @property
    def prompt_done(self) -> bool:
        return self.n_prefilled >= len(self.seq)

    @property
    def ctx_len(self) -> int:
        """Positions covered in the KV cache so far (cached + written)."""
        return self.n_prefilled + max(
            len(self.generated) - self.n_gen_at_admit - 1, 0)

    def sort_key(self) -> tuple:
        """Importance order: class first, oldest-admitted first."""
        return (self.req.priority, self.admit_seq)


@dataclasses.dataclass
class TickPlan:
    """One tick's shape-stable batch: (capacity, width) tokens plus per-slot
    start positions / valid-token counts (0 = inactive slot)."""
    width: int
    tokens: np.ndarray       # (capacity, width) int32
    start_pos: np.ndarray    # (capacity,) int32
    n_tokens: np.ndarray     # (capacity,) int32
    samples: list = dataclasses.field(default_factory=list)
    # slots whose sampled token must be consumed this tick (finished a
    # prompt, or in decode phase); mid-prefill slots ignore the sample


class Scheduler:
    def __init__(self, capacity: int, prefill_chunk: int,
                 allocator: PageAllocator, page_size: int, max_pages: int,
                 token_budget: Optional[int] = None,
                 first_chunk: Optional[int] = None,
                 paged: bool = True,
                 prefix_cache: Optional[PrefixCache] = None,
                 class_shares: Optional[dict] = None,
                 metrics=None, tracer=None):
        if prefill_chunk < 1:
            raise ValueError(f"prefill_chunk must be >= 1, {prefill_chunk}")
        self.capacity = int(capacity)
        self.prefill_chunk = int(prefill_chunk)
        # jumbo width for the FIRST chunk of a long prompt (None/0 = off)
        self.first_chunk = int(first_chunk) if first_chunk else None
        if self.first_chunk is not None \
                and self.first_chunk <= self.prefill_chunk:
            raise ValueError(
                f"first_chunk {self.first_chunk} must exceed prefill_chunk "
                f"{self.prefill_chunk} (it is the jumbo width; use None to "
                "disable)")
        self.allocator = allocator
        self.page_size = int(page_size)
        self.max_pages = int(max_pages)
        # False for models with no attention layers: recurrent state is a
        # slot-indexed pool (O(1) per slot), so no pages are ever allocated
        # and context length is not page-capped
        self.paged = bool(paged)
        self.prefix_cache = prefix_cache
        if prefix_cache is not None and not self.paged:
            raise ValueError("prefix_cache shares KV *pages* — meaningless "
                             "for a page-free (pure-recurrent) scheduler")
        # per-class prefill budget weights; default: class c weighs 2^-c
        self.class_shares = dict(class_shares or {})
        # default: every slot can decode AND one full (jumbo) chunk can
        # prefill — without headroom for first_chunk the jumbo grant would
        # always clamp back to the regular width
        self.token_budget = int(
            token_budget or (capacity + (self.first_chunk or prefill_chunk)))
        if self.token_budget < max(capacity, prefill_chunk):
            raise ValueError(
                f"token_budget {self.token_budget} < "
                f"max(capacity={capacity}, prefill_chunk={prefill_chunk}) "
                "would starve decode or deadlock prefill")
        self.waiting: dict[int, deque] = {}      # class -> _WaitEntry deque
        self.slots: list[Optional[_Slot]] = [None] * self.capacity
        self._admit_clock = 0
        self._pending_copies: list[tuple[int, int]] = []   # (src, dst)
        self._freed_slots: set[int] = set()    # vacated by preempt/finish
        # scheduling counters live in the metrics registry — the engine
        # passes its own so stats / Prometheus read the same numbers; a
        # standalone scheduler gets a private live registry
        m = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._m_admissions = m.counter(
            "repro_sched_admissions_total",
            "requests admitted into a slot (resumed = after a preemption)",
            labelnames=("resumed",))
        self._m_preemptions = m.counter(
            "repro_sched_preemptions_total",
            "requests preempted and requeued")
        self._m_famine = m.counter(
            "repro_sched_famine_ticks_total",
            "empty ticks emitted under total page famine")
        self._m_prefill_chunks = m.counter(
            "repro_sched_prefill_chunks_total", "prefill chunks scheduled")
        self._m_tokens = m.counter(
            "repro_sched_tokens_total",
            "tokens scheduled into ticks, by kind (prefill/decode)",
            labelnames=("kind",))
        self._m_cow = m.counter(
            "repro_sched_cow_copies_total",
            "copy-on-write page copies queued at admission")

    # -- counters (registry-backed; kept as the original attribute names) ---

    @property
    def n_prefill_chunks(self) -> int:
        return int(self._m_prefill_chunks.value())

    @property
    def n_scheduled_tokens(self) -> int:
        return int(self._m_tokens.total())

    @property
    def n_preemptions(self) -> int:
        return int(self._m_preemptions.value())

    # -- load (the router's least-loaded signal) ----------------------------

    @property
    def n_queued(self) -> int:
        """Requests admitted but not finished: waiting + in a slot."""
        return (sum(len(q) for q in self.waiting.values())
                + sum(s is not None for s in self.slots))

    @property
    def n_active(self) -> int:
        return sum(s is not None for s in self.slots)

    @property
    def n_reserved_pages(self) -> int:
        """KV pages currently held by admitted requests (excludes the
        prefix-cache tree's own references)."""
        return sum(len(s.pages) for s in self.slots if s is not None)

    # -- admission ----------------------------------------------------------

    def add(self, req: Request, now: float = 0.0) -> None:
        if len(req.prompt) < 1 or req.max_new_tokens < 1:
            raise ValueError(f"request {req.rid}: need a non-empty prompt "
                             "and max_new_tokens >= 1")
        req.priority = resolve_priority(req.priority)
        if self.paged:
            need = pages_for(len(req.prompt) + req.max_new_tokens,
                             self.page_size)
            if need > self.max_pages or need > self.allocator.n_pages - 1:
                raise ValueError(
                    f"request {req.rid} needs {need} pages "
                    f"(prompt {len(req.prompt)} + max_new "
                    f"{req.max_new_tokens}) but the engine caps at "
                    f"{self.max_pages} pages/slot and "
                    f"{self.allocator.n_pages - 1} total")
        self.waiting.setdefault(req.priority, deque()).append(
            _WaitEntry(req=req, t_submit=now))
        self.tracer.request_submit(req.rid, req.priority, len(req.prompt))

    def _waiting_classes(self) -> list[int]:
        return sorted(c for c, q in self.waiting.items() if q)

    def _admit_into(self, i: int, now: float) -> None:
        """Admit the most important waiting request into free slot ``i``."""
        entry = self.waiting[self._waiting_classes()[0]].popleft()
        seq = np.asarray(entry.req.prompt, np.int32)
        if entry.generated:                # resume: regenerate dropped KV
            seq = np.concatenate([seq, np.asarray(entry.generated,
                                                  np.int32)])
        pages, n_cached = [], 0
        if self.prefix_cache is not None:
            pages, n_cached, cow_src = self.prefix_cache.match(seq)
            if cow_src is not None:
                # private copy of the partially matching boundary page
                dst = self._alloc_pages(1)
                if dst:
                    pages += dst
                    self._pending_copies.append((cow_src, dst[0]))
                    self._m_cow.inc()
                else:                      # no page for the copy: round the
                    n_cached = len(pages) * self.page_size   # match down
                    self.allocator.free([cow_src])
        self._admit_clock += 1
        self.slots[i] = _Slot(
            req=entry.req, seq=seq, pages=pages,
            admit_seq=self._admit_clock, n_cached=n_cached,
            n_prefilled=n_cached, generated=list(entry.generated),
            n_gen_at_admit=len(entry.generated),
            n_preempted=entry.n_preempted, t_submit=entry.t_submit,
            t_admit=now, t_first=entry.t_first)
        resumed = entry.n_preempted > 0
        self._m_admissions.inc(resumed=str(resumed).lower())
        self.tracer.request_admit(entry.req.rid, resumed, n_cached)

    def _admit(self, now: float) -> None:
        for i in range(self.capacity):
            if not self._waiting_classes():
                return
            if self.slots[i] is None:
                self._admit_into(i, now)
        # every slot busy: a strictly more important waiting request may
        # preempt the least-important (then youngest) running slot
        while True:
            classes = self._waiting_classes()
            if not classes:
                return
            occupied = [i for i, s in enumerate(self.slots) if s is not None]
            if len(occupied) < self.capacity:
                return                     # a slot freed up: next tick admits
            victim = max(occupied, key=lambda i: self.slots[i].sort_key())
            if self.slots[victim].req.priority <= classes[0]:
                return                     # nobody strictly less important
            self._preempt(victim, now)
            self._admit_into(victim, now)

    # -- preemption ---------------------------------------------------------

    def _preempt(self, i: int, now: float) -> None:
        """Release slot ``i``'s pages and requeue its request at the FRONT
        of its class (so it resumes as soon as resources allow)."""
        s = self.slots[i]
        self.allocator.free(s.pages)
        self.slots[i] = None
        self._freed_slots.add(i)
        self._m_preemptions.inc()
        self.tracer.request_preempt(s.req.rid)
        self.waiting.setdefault(s.req.priority, deque()).appendleft(
            _WaitEntry(req=s.req, t_submit=s.t_submit,
                       generated=list(s.generated),
                       n_preempted=s.n_preempted + 1, t_first=s.t_first))

    def _alloc_pages(self, n: int) -> list[int]:
        """Allocate ``n`` pages, evicting cold prefix-cache pages if the
        free list runs dry. Returns [] (not an exception) when short."""
        short = n - self.allocator.n_free
        if short > 0 and self.prefix_cache is not None:
            self.prefix_cache.evict(short)
        if n > self.allocator.n_free:
            return []
        return self.allocator.alloc(n)

    def _ensure_pages(self, i: int, n_total: int, now: float) -> bool:
        """Grow slot ``i``'s page list to ``n_total`` pages, preempting
        less-important younger page-holders if eviction isn't enough.
        False = could not (slot may have preempted ITSELF and be gone)."""
        s = self.slots[i]
        while True:
            got = self._alloc_pages(n_total - len(s.pages))
            if got or n_total <= len(s.pages):
                s.pages += got
                return True
            victims = [j for j, v in enumerate(self.slots)
                       if v is not None and v.pages
                       and (j == i or v.sort_key() > s.sort_key())]
            if not victims:
                return False               # defer: nothing rightfully ours
            j = max(victims, key=lambda j: self.slots[j].sort_key())
            self._preempt(j, now)
            if j == i:
                return False               # preempted ourselves

    # -- tick construction --------------------------------------------------

    def has_work(self) -> bool:
        return bool(self._waiting_classes()) \
            or any(s is not None for s in self.slots)

    def page_table(self) -> np.ndarray:
        table = np.zeros((self.capacity, self.max_pages), np.int32)
        for i, s in enumerate(self.slots):
            if s is not None:
                table[i, :len(s.pages)] = s.pages
        return table

    def drain_copies(self) -> list[tuple[int, int]]:
        """COW copies queued by admissions since the last drain, as
        ``(src, dst)`` page pairs. The caller must copy ``src``'s pool
        content onto ``dst`` BEFORE running the tick's step (the step may
        write into ``dst``), then release the pinned source with
        ``allocator.free([src])``."""
        out, self._pending_copies = self._pending_copies, []
        return out

    def drain_freed_slots(self) -> set:
        """Slot indices vacated (preempt or finish) since the last drain —
        the engine zeroes their recurrent state, unless re-occupied
        already. Host-side hygiene; the in-step position-0 reset is the
        correctness invariant either way."""
        out, self._freed_slots = self._freed_slots, set()
        return out

    def _prefill_quota(self, prefill: list, budget: int) -> dict:
        """SLO shares: split the post-decode budget across the classes
        with prefill demand, proportional to ``class_shares`` (default
        2^-class), integer leftover to the most important class."""
        classes = sorted({s.req.priority for _, s in prefill})
        w = {c: float(self.class_shares.get(c, 2.0 ** -c)) for c in classes}
        tot = sum(w.values()) or 1.0
        quota = {c: int(budget * w[c] / tot) for c in classes}
        quota[classes[0]] += budget - sum(quota.values())
        return quota

    def next_tick(self, now: float = 0.0) -> Optional[TickPlan]:
        """Admit waiting requests, then plan one tick. None = idle."""
        self._admit(now)
        if all(s is None for s in self.slots):
            return None
        budget = self.token_budget
        decode = sorted(((i, s) for i, s in enumerate(self.slots)
                         if s is not None and s.prompt_done),
                        key=lambda t: t[1].sort_key())
        # decode never stalls: 1 token per decoding slot, off the top —
        # but lazily allocate the page its token lands in first
        decodes: list[tuple[int, _Slot]] = []
        for i, s in decode:
            if self.slots[i] is not s:
                continue                   # preempted by an earlier slot's growth
            if self.paged and not self._ensure_pages(
                    i, pages_for(s.ctx_len + 1, self.page_size), now):
                continue                   # deferred (or self-preempted)
            if self.slots[i] is s:         # survived any preemption round
                decodes.append((i, s))
        budget -= len(decodes)

        prefill = sorted(((i, s) for i, s in enumerate(self.slots)
                          if s is not None and not s.prompt_done),
                         key=lambda t: t[1].sort_key())
        grants: list[tuple[int, _Slot, int]] = []
        if prefill:
            quota = self._prefill_quota(prefill, max(budget, 0))
            for i, s in prefill:
                if self.slots[i] is not s:
                    continue               # preempted by an earlier grant
                chunk = self.prefill_chunk
                if (self.first_chunk is not None
                        and s.n_prefilled == s.n_cached
                        and len(s.seq) - s.n_cached > self.prefill_chunk):
                    chunk = self.first_chunk    # jumbo first chunk (TTFT)
                c = min(chunk, len(s.seq) - s.n_prefilled,
                        max(quota[s.req.priority], 0), max(budget, 0))
                if c > 0 and self.paged and not self._ensure_pages(
                        i, pages_for(s.n_prefilled + c, self.page_size),
                        now):
                    if self.slots[i] is not s:
                        continue           # self-preempted: grant dropped
                    # shrink to the pages already owned (page-aligned)
                    c = min(c, len(s.pages) * self.page_size
                            - s.n_prefilled)
                if c <= 0:
                    continue
                grants.append((i, s, c))
                quota[s.req.priority] -= c
                budget -= c
        # width stays one of {1, prefill_chunk, first_chunk}: a jumbo grant
        # clamped (by budget/shares/prompt length) to <= prefill_chunk rides
        # the regular width, so no fourth shape ever compiles
        max_grant = max((c for _, _, c in grants), default=0)
        if max_grant == 0:
            width = 1
        elif max_grant <= self.prefill_chunk:
            width = self.prefill_chunk
        else:
            width = self.first_chunk

        if not decodes and not grants:
            # pathological page famine: every slot deferred. Emit an empty
            # 1-wide plan so the engine loop keeps ticking (admission /
            # eviction may unblock the next tick).
            self._m_famine.inc()
            self.tracer.instant("famine_tick", cat="engine")
            return TickPlan(width=1,
                            tokens=np.zeros((self.capacity, 1), np.int32),
                            start_pos=np.zeros(self.capacity, np.int32),
                            n_tokens=np.zeros(self.capacity, np.int32))

        tokens = np.zeros((self.capacity, width), np.int32)
        start = np.zeros(self.capacity, np.int32)
        n_tok = np.zeros(self.capacity, np.int32)
        samples = []
        for i, s in decodes:
            tokens[i, 0] = s.generated[-1]
            start[i] = s.ctx_len
            n_tok[i] = 1
            samples.append(i)
        for i, s, c in grants:
            tokens[i, :c] = s.seq[s.n_prefilled:s.n_prefilled + c]
            start[i] = s.n_prefilled
            n_tok[i] = c
            self._m_prefill_chunks.inc()
            self.tracer.request_prefill_chunk(s.req.rid, c)
            if s.n_prefilled + c >= len(s.seq):
                samples.append(i)           # prompt completes: sample now
        if decodes:
            self._m_tokens.inc(len(decodes), kind="decode")
        n_prefill_tok = int(n_tok.sum()) - len(decodes)
        if n_prefill_tok:
            self._m_tokens.inc(n_prefill_tok, kind="prefill")
        return TickPlan(width=width, tokens=tokens, start_pos=start,
                        n_tokens=n_tok, samples=samples)

    # -- tick completion ----------------------------------------------------

    def complete_tick(self, plan: TickPlan, sampled: np.ndarray,
                      now: float = 0.0) -> list[dict]:
        """Feed back the sampled tokens; returns records of requests that
        finished this tick (their slots and pages are already recycled).
        The scheduler retains nothing about finished requests — the caller
        owns the records, so a long-lived engine stays O(capacity)."""
        finished: list[dict] = []
        for i in range(self.capacity):
            s = self.slots[i]
            if s is None or plan.n_tokens[i] == 0:
                continue
            if not s.prompt_done:
                s.n_prefilled += int(plan.n_tokens[i])
                if s.prompt_done and self.prefix_cache is not None:
                    # prompt pages are final now; cache the immutable ones
                    n_full = len(s.req.prompt) // self.page_size
                    self.prefix_cache.insert(s.req.prompt,
                                             s.pages[:n_full])
            if i not in plan.samples:
                continue                    # mid-prefill: ignore the sample
            tok = int(sampled[i])
            if s.t_first is None:
                s.t_first = now
                self.tracer.request_first_token(s.req.rid)
            s.generated.append(tok)
            self.tracer.request_decode(s.req.rid)
            done = (len(s.generated) >= s.req.max_new_tokens
                    or (s.req.eos_id is not None and tok == s.req.eos_id))
            if s.req.stream is not None:
                s.req.stream(s.req.rid, tok, done)
            if done:
                finished.append(self._finish(i, now))
        return finished

    def _finish(self, i: int, now: float) -> dict:
        s = self.slots[i]
        self.allocator.free(s.pages)
        self.slots[i] = None
        self._freed_slots.add(i)
        self.tracer.request_finish(s.req.rid)
        return {
            "rid": s.req.rid,
            "slot": i,                      # for engine-side state recycling
            "tokens": np.asarray(s.generated, np.int32),
            "n_prompt": len(s.req.prompt),
            "n_generated": len(s.generated),
            "priority": s.req.priority,
            "n_cached": s.n_cached,
            "n_preempted": s.n_preempted,
            "t_submit": s.t_submit, "t_admit": s.t_admit,
            "t_first": s.t_first, "t_done": now,
        }
