"""Continuous-batching serving engine over compressed (or dense) weights.

Port of ``repro.serve.engine``. ``ServeEngine`` serves many concurrent,
mixed-length requests from one fixed-capacity slot batch: each tick runs
**one mixed step** (``Model.paged_step``) over all slots, any mix of
prefill chunks and single-token decodes with inactive slots masked by
``n_tokens == 0``, then the sampler on the device, then host-side
bookkeeping (admission, streaming callbacks, slot recycling). ``params``
may be a raw tree or ``CompressedParams`` (BlockCSR / PaletteBCSR): the
step runs the same ``sparse_matmul`` kernels as ``generate``.

Where the reference jits its step, the port calls it as it is (PyTorch
runs eagerly), and where the reference donates the pools to the step, the
port updates the pool tensors in place. The sampled tokens reach the host
once per tick. Per-request memory lives in the slot resource pools of
``serve/paged_kv.py``: block-paged KV for attention layers, slot-indexed
state for RG-LRU and RWKV layers, zeroed when a slot is vacated. A model
without attention layers (rwkv6) allocates no pages. Attention inside the
step dispatches by
``EngineConfig.attn_backend``: 'cuda' walks page tables with the
hand-written paged flash-decode kernel (``kernels/paged_attention``)
instead of gathering the whole pool.
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.kernels.bsr_spmm import ops as spmm_ops
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.obs.metrics import MetricsRegistry, slo_summary
from repro_torch.obs.trace import NULL_TRACER
from repro_torch.serve import api
from repro_torch.serve.api import ApiValidationError, Completion, SamplingParams
from repro_torch.models.transformer import RECURRENT_KINDS, layer_kinds
from repro_torch.serve.paged_kv import (PageAllocator, copy_page,
                                        init_paged_cache, pages_for,
                                        slot_resource_bytes, unsupported_kinds,
                                        zero_state_slots)
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.scheduler import Request as _SchedRequest
from repro_torch.serve.scheduler import Scheduler
from repro_torch.serve.step import make_sampler
from repro_torch.sparse.compress import CompressedParams, iter_bcsr

_ATTN_BACKENDS = ("auto", "cuda", "ref")

# Every engine's tick holds this lock through its host work and releases it
# only while it waits for its sampled tokens. The reference's tick is one
# jitted call, which releases the GIL once; the port's makes thousands of
# torch calls a tick, each of which releases it, so engines in threads (the
# router's replicas) would hand the GIL to one another at every call. Under
# the lock they take turns by whole ticks, and one engine's host work
# overlaps another's device work. A lone engine takes it uncontended.
HOST_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Knobs of the continuous-batching engine.

    max_batch:     fixed slot capacity of the mixed step.
    prefill_chunk: prompt tokens consumed per slot per tick (long prompts
                   prefill across many ticks, interleaved with decode).
    page_size:     KV page length in tokens.
    max_seq_len:   per-request context cap (prompt + generated); sets the
                   page-table width.
    n_pages:       total pages per layer pool; default sizes every slot for
                   ``max_seq_len`` (+1 for the reserved trash page 0).
    token_budget:  max tokens scheduled per tick (decode first, remainder
                   to prefill chunks); default ``max_batch + first_chunk``
                   (or ``+ prefill_chunk`` when no jumbo width is set).
    first_chunk:   optional jumbo width (> prefill_chunk) for the FIRST
                   chunk of a long prompt, a third tick width that keeps
                   TTFT off the steady-state chunk pace.
    attn_backend:  paged-attention dispatch: 'cuda' = the hand-written
                   paged flash-decode kernel (the reference's 'pallas'),
                   'ref' = gather then softmax, 'auto' (default) = by the
                   tensors' device.
    kv_splits:     flash-decode KV-split lanes per slot on the 'cuda'
                   backend (1 = no split).
    prefix_cache:  radix-tree prefix caching: requests sharing a prompt
                   prefix share physical KV pages (refcounted, COW on the
                   first diverging page).
    class_shares:  optional ((class, weight), ...) pairs overriding the
                   per-priority-class prefill token-budget shares
                   (default: class c weighs 2^-c).
    sampling:      engine-wide ``SamplingParams`` (a request carrying
                   explicit sampling must match it).

    One value is everything needed to spawn an identical replica
    (``to_json`` / ``from_json``).
    """
    max_batch: int = 8
    prefill_chunk: int = 32
    page_size: int = 16
    max_seq_len: int = 256
    n_pages: Optional[int] = None
    token_budget: Optional[int] = None
    first_chunk: Optional[int] = None
    attn_backend: str = "auto"
    kv_splits: int = 1
    prefix_cache: bool = False
    class_shares: Optional[tuple] = None
    sampling: SamplingParams = SamplingParams()

    def __post_init__(self):
        if self.attn_backend not in _ATTN_BACKENDS:
            raise ApiValidationError(
                f"attn_backend must be one of {_ATTN_BACKENDS}, got "
                f"{self.attn_backend!r}")
        if self.class_shares is not None:
            object.__setattr__(self, "class_shares",
                               tuple((int(c), float(w))
                                     for c, w in self.class_shares))

    @property
    def pages_per_slot(self) -> int:
        return pages_for(self.max_seq_len, self.page_size)

    @property
    def total_pages(self) -> int:
        return (self.n_pages if self.n_pages is not None
                else self.max_batch * self.pages_per_slot + 1)

    def to_json(self) -> dict:
        """Plain-dict form (fields that differ from their defaults)."""
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)
             if getattr(self, f.name) != f.default}
        if "sampling" in d:
            d["sampling"] = self.sampling.to_json()
        if self.class_shares is not None:
            d["class_shares"] = [list(p) for p in self.class_shares]
        return d

    @classmethod
    def from_json(cls, d: dict) -> "EngineConfig":
        allowed = tuple(f.name for f in dataclasses.fields(cls))
        api._check_keys(d, allowed, "engine_config")
        kw = dict(d)
        if kw.get("sampling") is not None:
            kw["sampling"] = SamplingParams.from_json(
                kw["sampling"], "engine_config.sampling")
        if kw.get("class_shares") is not None:
            kw["class_shares"] = tuple(tuple(p) for p in kw["class_shares"])
        return cls(**kw)


class ServeEngine:
    """The step loop. ``sampler(logits, generator) -> tokens`` runs on the
    device after each step; the default is built from ``config.sampling``
    (greedy when temperature == 0). ``generator`` (a ``torch.Generator``
    on the model's device) drives sampling; it cannot reproduce the
    reference's ``jax.random`` stream, greedy tokens are comparable. A
    tick runs under ``HOST_LOCK``."""

    def __init__(self, model, params, config: EngineConfig,
                 sampler: Optional[Callable] = None,
                 generator: Optional[torch.Generator] = None, *,
                 metrics=None, tracer=None, profiler=None):
        bad = unsupported_kinds(model)
        if bad:
            raise NotImplementedError(
                f"{model.cfg.name}: layer kind(s) {', '.join(map(repr, bad))}"
                " have no slot resource pool — the engine covers "
                "attn/rglru/rwkv; use the sequential serving path "
                "(launch/serve without --engine)")
        self.model = model
        self.params = params
        self.config = config
        self.device = model.device
        kinds = layer_kinds(model.cfg)
        self.has_attn = "attn" in kinds
        self.has_state = any(k in RECURRENT_KINDS for k in kinds)
        # one registry shared by the allocator, prefix cache, scheduler and
        # the engine's own tick instruments: the stats dict and the
        # Prometheus exposition read the same numbers
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.profiler = profiler
        self.pools = init_paged_cache(model, config.total_pages,
                                      config.page_size,
                                      capacity=config.max_batch)
        self.pool_bytes = slot_resource_bytes(self.pools)
        self.allocator = PageAllocator(config.total_pages,
                                       metrics=self.metrics)
        self.prefix_cache = None
        if config.prefix_cache:
            if self.has_state:
                raise NotImplementedError(
                    f"{model.cfg.name}: --prefix-cache shares paged KV, but "
                    "recurrent (rglru/rwkv) state is not position-sliceable "
                    "— prefix caching covers attention-only models")
            self.prefix_cache = PrefixCache(self.allocator, config.page_size,
                                            metrics=self.metrics)
        self.scheduler = Scheduler(
            capacity=config.max_batch, prefill_chunk=config.prefill_chunk,
            allocator=self.allocator, page_size=config.page_size,
            max_pages=config.pages_per_slot,
            token_budget=config.token_budget,
            first_chunk=config.first_chunk,
            paged=self.has_attn,
            prefix_cache=self.prefix_cache,
            class_shares=dict(config.class_shares or ()),
            metrics=self.metrics, tracer=self.tracer)
        self._m_ticks = self.metrics.counter(
            "repro_engine_ticks_total", "engine ticks, by compiled width",
            labelnames=("width",))
        self._m_tick_tokens = self.metrics.histogram(
            "repro_engine_tick_tokens",
            "tokens scheduled per tick (token-budget utilization)")
        self._m_sampler_batch = self.metrics.histogram(
            "repro_engine_sampler_batch",
            "slots consuming their sampled token per tick")
        self._m_occupancy = self.metrics.histogram(
            "repro_engine_page_occupancy", "allocated KV pages per tick")
        self._m_requests = self.metrics.counter(
            "repro_engine_requests_total", "requests submitted, by class",
            labelnames=("request_class",))
        self._m_finished = self.metrics.counter(
            "repro_engine_requests_finished_total",
            "requests finished, by class", labelnames=("request_class",))
        self._m_gen_tokens = self.metrics.counter(
            "repro_engine_generated_tokens_total", "tokens generated")
        self._sampler = sampler or make_sampler(config.sampling)
        self._generator = generator
        self._next_rid = 0
        self.tick_widths: set[int] = set()   # distinct step widths

    @property
    def n_ticks(self) -> int:
        """Total ticks run (registry-backed; all widths)."""
        return int(self._m_ticks.total())

    def load_kernels(self) -> None:
        """Build and load now every kernel library this engine's step
        launches on the card (nothing on the CPU): the spmm kernels for
        compressed weights (and their expert instantiations for an MoE
        model), the paged kernel unless ``attn_backend='ref'``. A first
        build runs nvcc for 35-66 s; the router calls this before its
        worker threads start, so that no tick waits on a build."""
        if self.device.type != "cuda":
            return
        if isinstance(self.params, CompressedParams) \
                and next(iter_bcsr(self.params), None) is not None:
            spmm_ops._lib()
            if self.model.cfg.moe is not None:
                spmm_ops._lib(experts=True)
        if self.has_attn and self.config.attn_backend != "ref":
            paged_ops._lib()

    # -- request intake -----------------------------------------------------

    def submit(self, request: api.Request,
               stream: Optional[Callable] = None) -> int:
        """Queue one ``api.Request``; returns its request id.
        ``stream(event: api.StreamEvent)`` fires for every generated token
        as it is produced. A request carrying explicit ``sampling`` must
        match the engine's ``config.sampling``: the sampler is engine-wide.
        """
        if not isinstance(request, api.Request):
            raise ApiValidationError(
                f"submit() takes an api.Request, got "
                f"{type(request).__name__}")
        if request.sampling is not None \
                and request.sampling != self.config.sampling:
            raise ApiValidationError(
                f"request.sampling={request.sampling} != the engine's "
                f"sampling={self.config.sampling}: the sampler is "
                "engine-wide (EngineConfig.sampling); route this request "
                "to a matching engine or drop request.sampling")
        if request.request_id is None:
            rid = self._next_rid
        else:
            rid = int(request.request_id)
        self._next_rid = max(self._next_rid, rid) + 1
        cb = None
        if stream is not None:
            def cb(_rid, token, done, _stream=stream, _n=[0]):
                _stream(api.StreamEvent(request_id=_rid, token=int(token),
                                        index=_n[0], done=bool(done)))
                _n[0] += 1
        req = _SchedRequest(rid=rid, prompt=request.prompt_ids,
                            max_new_tokens=request.max_new_tokens,
                            eos_id=request.eos_id, stream=cb,
                            priority=request.priority)
        self.scheduler.add(req, now=time.perf_counter())
        self._m_requests.inc(request_class=str(req.priority))
        return rid

    # -- the step loop ------------------------------------------------------

    def _device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    def _tick_step(self, plan) -> np.ndarray:
        """The mixed step of one tick and its sampling, launched under
        ``HOST_LOCK``, then the sampled tokens on the host (the tick's one
        device sync), waited for with the lock released. The profiler's
        ``engine/tick_step`` ends when the tokens arrive, before the lock
        is taken back: waiting for it is other engines' host work."""
        t0 = time.perf_counter()
        with torch.inference_mode():
            logits, self.pools = self.model.paged_step(
                self.params, self._device(plan.tokens), self.pools,
                self._device(self.scheduler.page_table()),
                self._device(plan.start_pos), self._device(plan.n_tokens),
                backend=self.config.attn_backend,
                kv_splits=self.config.kv_splits)
            sampled = self._sampler(logits, self._generator)
        HOST_LOCK.release()
        try:
            sampled = sampled.cpu().numpy()
            if self.profiler is not None:
                self.profiler.wall_since("engine/tick_step", t0)
            return sampled
        finally:
            HOST_LOCK.acquire()

    def step(self) -> list[dict]:
        """Run one tick; returns the requests that finished during it."""
        with HOST_LOCK:
            return self._step()

    def _step(self) -> list[dict]:
        tracer = self.tracer
        tick_t0 = tracer.now_us()           # tick span opens at schedule
        plan = self.scheduler.next_tick(now=time.perf_counter())
        if plan is None:
            return []
        tracer.complete_span("schedule", tick_t0)
        # COW copies queued by this tick's admissions land BEFORE the step
        # (prefill may overwrite the copy from the divergence point); the
        # pinned source page is released once the copy is issued (the
        # stream orders the copy before the step)
        for src, dst in self.scheduler.drain_copies():
            copy_page(self.pools, src, dst)
            self.allocator.free([src])
        self.tick_widths.add(plan.width)
        n_tok = int(plan.n_tokens.sum())
        with tracer.span("step", width=plan.width, tokens=n_tok):
            sampled = self._tick_step(plan)
        self._m_ticks.inc(width=str(plan.width))
        self._m_tick_tokens.observe(n_tok)
        self._m_sampler_batch.observe(len(plan.samples))
        if self.has_attn:
            self._m_occupancy.observe(
                self.allocator.n_pages - 1 - self.allocator.n_free)
        with tracer.span("bookkeep"):
            finished = self.scheduler.complete_tick(
                plan, sampled, now=time.perf_counter())
            # zero the recurrent state of slots vacated this tick (finish
            # or preemption) unless a new occupant landed already: the
            # in-step position-0 reset covers that occupant regardless
            freed = [i for i in self.scheduler.drain_freed_slots()
                     if self.scheduler.slots[i] is None]
            if self.has_state and freed:
                mask = np.zeros(self.config.max_batch, bool)
                mask[freed] = True
                zero_state_slots(self.pools, mask)
        for r in finished:
            self._m_finished.inc(request_class=str(r["priority"]))
            self._m_gen_tokens.inc(r["n_generated"])
        tracer.complete_span("tick", tick_t0, width=plan.width, tokens=n_tok)
        return finished

    def run(self, requests=None) -> dict:
        """Serve until the queue drains. ``requests``: optional iterable of
        ``api.Request`` values or ``(prompt, max_new_tokens)`` tuples.
        Returns ``{"results": {rid: tokens}, "completions":
        [api.Completion, ...], "stats": ...}``."""
        for r in (requests or []):
            if isinstance(r, api.Request):
                self.submit(r)
            else:
                prompt, gen = r
                self.submit(api.Request(prompt=prompt, max_new_tokens=gen))
        t0 = time.perf_counter()
        ticks0 = self.n_ticks
        chunks0 = self.scheduler.n_prefill_chunks
        tokens0 = self.scheduler.n_scheduled_tokens
        finished: list[dict] = []
        while self.scheduler.has_work():
            finished.extend(self.step())
        wall = time.perf_counter() - t0
        stats = self._stats(finished, wall)
        # per-run counters (the engine object is reusable across runs)
        stats["n_ticks"] = self.n_ticks - ticks0
        stats["n_prefill_chunks"] = \
            self.scheduler.n_prefill_chunks - chunks0
        stats["n_scheduled_tokens"] = \
            self.scheduler.n_scheduled_tokens - tokens0
        return {"results": {r["rid"]: r["tokens"] for r in finished},
                "completions": [Completion.from_record(r) for r in finished],
                "stats": stats}

    def _stats(self, finished: list[dict], wall: float) -> dict:
        """Throughput/latency summary of a drained run, with per-priority-
        class SLO accounting (p50/p95 TTFT and latency per class) and the
        prefix-cache hit rate. Percentiles over an empty record set are
        ``None`` (``obs.metrics.pct``), never a fabricated 0.0."""
        n_new = sum(r["n_generated"] for r in finished)

        def slo(records) -> dict:
            return slo_summary(
                (r["t_first"] - r["t_submit"] for r in records
                 if r["t_first"] is not None),
                (r["t_done"] - r["t_submit"] for r in records),
                len(records),
                n_preempted=sum(r["n_preempted"] for r in records))

        return {
            "n_requests": len(finished),
            "n_generated": int(n_new),
            "n_prompt": int(sum(r["n_prompt"] for r in finished)),
            "n_cached_tokens": int(sum(r["n_cached"] for r in finished)),
            "n_preemptions": self.scheduler.n_preemptions,
            "prefix_hit_rate": (self.prefix_cache.hit_rate
                                if self.prefix_cache is not None else 0.0),
            "kv_page_bytes": self.pool_bytes["kv_page_bytes"],
            "state_slot_bytes": self.pool_bytes["state_slot_bytes"],
            "wall_s": wall,
            "tok_s": n_new / wall if wall > 0 else 0.0,
            **slo(finished),
            "by_class": {c: slo([r for r in finished if r["priority"] == c])
                         for c in sorted({r["priority"] for r in finished})},
        }
