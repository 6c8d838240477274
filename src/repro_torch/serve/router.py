"""Multi-replica serving router: one asyncio front-end, N ``ServeEngine``
replicas (port of ``repro.serve.router``).

Compression buys *replicas*: every replica reads the same compressed
``params`` (the weights exist once on the device, whatever N) and owns only
its slot resource pools, so the smaller the compressed model, the more
data-parallel engines fit on one card. The router turns that into
aggregate tokens/s.

Architecture
------------

* Each replica is a **worker thread** owning one ``ServeEngine`` built from
  the same ``EngineConfig`` value. Every engine's tick holds the engine
  module's ``HOST_LOCK`` through its host work (the scheduler, the Python
  layer loop, the launches) and releases it while it waits for the
  device, so one replica's host work overlaps another's device work, and
  the replicas do not hand the GIL to one another at each of a tick's
  thousands of torch calls. On the card each worker runs
  its engine under its own ``torch.cuda.Stream`` (entered inside the
  thread: the current stream is per thread), which first waits on the
  stream that built the params and the pools; every kernel wrapper
  launches on the current stream.
* Kernel libraries are built and loaded before any worker starts
  (``ServeEngine.load_kernels``): a first build takes longer than the
  stall timeout. Launch counters, the profiler, the tracer's track ids and
  the head's rounded-table memo are safe under threads (see their
  modules).
* The router itself is **asyncio**: ``submit()`` dispatches an
  ``api.Request`` and returns a future ``api.Completion``; streaming
  callbacks receive ``api.StreamEvent`` (with ``replica`` set) in the
  event loop thread. Workers talk back through
  ``loop.call_soon_threadsafe`` only: all router state is mutated in the
  loop thread, with no locks.
* **Dispatch** (``--route``):
  - ``prefix`` (default): rendezvous-hash (HRW) the prompt's leading
    page-aligned tokens over the healthy replicas, so requests sharing a
    system prompt land where the radix prefix cache already holds it, and
    a replica's death remaps only its own keys. Prompts shorter than a
    page go least-loaded; a busy preferred replica is waited on (bounded
    by backpressure), not diverted: a diverted request would prefill the
    shared prefix cold anyway.
  - ``least-loaded``: queue depth + reserved KV pages, ties to the lowest
    replica index.
  - ``round-robin``: a modulo counter over the healthy replicas.
* **Backpressure**: at most ``max_inflight`` router-side requests per
  replica (default ``2 * max_batch``); ``submit()`` awaits capacity.
* **Health**: a worker that raises marks itself dead at once, and its
  error is logged with its traceback; a monitor task also catches dead
  threads and heartbeat stalls (``stall_timeout_s`` with work pending). A
  failed replica is drained: its queued and running requests are
  **re-dispatched** as resume requests (the prompt plus the tokens
  generated so far, the budget reduced by as many), and greedy decoding
  makes the stitched stream equal an uninterrupted run token for token.
  Events of the old dispatch are dropped by an epoch check, so a token is
  streamed once. A CUDA error in a worker poisons the card for every
  replica: it fails every replica and every pending request, and
  ``serve`` raises. ``stop()`` joins every worker, and waits for its
  stream, before anything of theirs can be freed.
"""
from __future__ import annotations

import asyncio
import hashlib
import logging
import queue
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry, slo_summary
from repro_torch.serve.api import ApiValidationError, Completion, Request, StreamEvent
from repro_torch.serve.engine import EngineConfig, ServeEngine

ROUTE_POLICIES = ("prefix", "least-loaded", "round-robin")

_STOP = object()
log = logging.getLogger(__name__)


class ReplicaFailed(RuntimeError):
    """Every replica is dead: the request cannot be served."""


def _device_error(e: BaseException) -> bool:
    """A CUDA error: after one the card may refuse every replica's work."""
    return type(e).__name__ in ("AcceleratorError", "CudaError") or (
        isinstance(e, RuntimeError) and "CUDA error" in str(e))


class _Replica:
    """One worker thread, its engine, and the router's view of its load."""

    def __init__(self, idx: int, engine: ServeEngine, m_done, m_tokens):
        self.idx = idx
        self.engine = engine
        self.inbox: queue.Queue = queue.Queue()
        self.thread: Optional[threading.Thread] = None   # set by start()
        self.stream: Optional[torch.cuda.Stream] = None  # set by start()
        self.hb = time.monotonic()        # worker heartbeat (stall detection)
        self.error: Optional[BaseException] = None
        self.failed = False               # set by the router (loop thread)
        self.inflight = 0                 # router-side dispatched - finished
        # replica-labelled series in the router's registry, readable as the
        # attributes n_done / n_tokens
        self._m_done = m_done
        self._m_tokens = m_tokens
        self._post: Optional[Callable] = None   # set by Router.start
        self._epochs: dict[int, int] = {}       # rid -> dispatch epoch

    # -- worker thread ------------------------------------------------------

    def _run(self, built: Optional[torch.cuda.Event]):
        try:
            if self.stream is None:
                self._loop()
            else:
                with torch.cuda.stream(self.stream):
                    self.stream.wait_event(built)   # params and pools written
                    self._loop()
        except Exception as e:               # engine died: router re-dispatches
            self.error = e
            log.error("replica %d: worker raised", self.idx, exc_info=e)
            self._post("died", self.idx, 0, -1, e)

    def _loop(self):
        while True:
            self.hb = time.monotonic()
            busy = self.engine.scheduler.has_work()
            try:
                item = (self.inbox.get_nowait() if busy
                        else self.inbox.get(timeout=0.02))
            except queue.Empty:
                item = None
            while item is not None:
                if item is _STOP:
                    return
                req, cb, epoch = item
                self._epochs[req.request_id] = epoch
                try:
                    self.engine.submit(req, stream=cb)
                except Exception as e:       # bad request, not a dead engine
                    self._post("err", self.idx, epoch, req.request_id, e)
                try:
                    item = self.inbox.get_nowait()
                except queue.Empty:
                    item = None
            if self.engine.scheduler.has_work():
                for rec in self.engine.step():
                    self._post("done", self.idx,
                               self._epochs.get(rec["rid"], 0),
                               rec["rid"], rec)

    # -- router-side load signal (racy reads of worker state are fine: these
    # are heuristics, and each read of an int is consistent) --------------

    @property
    def n_done(self) -> int:
        return int(self._m_done.value(replica=str(self.idx)))

    @property
    def n_tokens(self) -> int:
        return int(self._m_tokens.value(replica=str(self.idx)))

    @property
    def load(self) -> float:
        sched = self.engine.scheduler
        return self.inflight + (sched.n_reserved_pages
                                / max(self.engine.config.total_pages, 1))


class _Inflight:
    """Router-side record of one request across (re-)dispatches."""

    __slots__ = ("rid", "request", "future", "stream", "replica", "epoch",
                 "generated", "n_redispatched", "t_submit", "t_first")

    def __init__(self, rid: int, request: Request, future, stream):
        self.rid = rid
        self.request = request
        self.future = future
        self.stream = stream
        self.replica = -1
        self.epoch = 0
        self.generated: list[int] = []
        self.n_redispatched = 0
        self.t_submit = time.perf_counter()
        self.t_first: Optional[float] = None


class Router:
    """Load-balance streaming requests over N engine replicas.

    ``engines`` must be built from one ``EngineConfig`` (use
    ``Router.build``): dispatch assumes replicas are interchangeable.
    Async surface: ``await start()``, ``fut = await submit(req)``,
    ``completion = await fut``, ``await stop()``. ``serve(requests)`` is
    the sync convenience wrapper mirroring ``ServeEngine.run``.
    """

    def __init__(self, engines: list[ServeEngine], *,
                 policy: str = "prefix", affinity_pages: int = 4,
                 max_inflight: Optional[int] = None,
                 stall_timeout_s: float = 30.0,
                 metrics=None):
        if not engines:
            raise ApiValidationError("router needs at least one replica")
        if policy not in ROUTE_POLICIES:
            raise ApiValidationError(
                f"unknown route policy {policy!r} — one of "
                f"{', '.join(ROUTE_POLICIES)}")
        self.policy = policy
        self.affinity_pages = int(affinity_pages)
        self.stall_timeout_s = float(stall_timeout_s)
        # router-level registry (each replica's engine has its own; see
        # ``to_prometheus`` for the merged fleet exposition)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_requests = self.metrics.counter(
            "repro_router_requests_total", "requests submitted to the fleet")
        self._m_dispatches = self.metrics.counter(
            "repro_router_dispatches_total",
            "dispatches to a replica inbox (re-dispatches included)",
            labelnames=("replica",))
        self._m_backpressure = self.metrics.counter(
            "repro_router_backpressure_waits_total",
            "submit/dispatch waits for replica capacity")
        self._m_failovers = self.metrics.counter(
            "repro_router_failovers_total", "replicas marked failed")
        self._m_redispatches = self.metrics.counter(
            "repro_router_redispatches_total",
            "in-flight requests re-dispatched off a failed replica")
        m_done = self.metrics.counter(
            "repro_router_completions_total", "completions, by replica",
            labelnames=("replica",))
        m_tokens = self.metrics.counter(
            "repro_router_streamed_tokens_total",
            "tokens streamed to the router, by replica",
            labelnames=("replica",))
        self.replicas = [_Replica(i, e, m_done, m_tokens)
                         for i, e in enumerate(engines)]
        self.max_inflight = int(max_inflight
                                or 2 * engines[0].config.max_batch)
        self._inflight: dict[int, _Inflight] = {}
        self._completions: list[Completion] = []
        self._next_rid = 0
        self._rr = 0                       # round-robin counter
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._cap_event: Optional[asyncio.Event] = None
        self._monitor_task = None
        self._started = False
        self._fail_after = None            # (replica idx, n_tokens) hook
        self._redispatches: set = set()    # tasks of _handle_failure

    @classmethod
    def build(cls, model, params, config: EngineConfig, n_replicas: int, *,
              generator_seed: Optional[int] = None, tracer=None,
              profiler=None, **kw) -> "Router":
        """Spawn ``n_replicas`` identical engines from one ``EngineConfig``.
        All replicas read the same (compressed) ``params``, so the weights
        exist once whatever N; each allocates its own pools. With
        ``generator_seed`` replica i samples from its own
        ``torch.Generator`` seeded ``generator_seed + i`` (a generator is
        not shared between threads). ``tracer`` and ``profiler`` are shared
        by the fleet; ``kw`` goes to the router."""
        engines = [ServeEngine(
            model, params, config,
            generator=(None if generator_seed is None else
                       torch.Generator(device=model.device).manual_seed(
                           generator_seed + i)),
            tracer=tracer, profiler=profiler)
            for i in range(int(n_replicas))]
        return cls(engines, **kw)

    # -- lifecycle ----------------------------------------------------------

    async def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._loop = asyncio.get_running_loop()
        self._cap_event = asyncio.Event()

        def post(kind, idx, epoch, rid, payload):
            handler = {"done": self._on_done, "err": self._on_error,
                       "died": self._on_died}[kind]
            try:
                self._loop.call_soon_threadsafe(handler, idx, epoch, rid,
                                                payload)
            except RuntimeError:           # loop already closed (shutdown)
                pass

        for rep in self.replicas:
            rep._post = post
            if rep.failed or (rep.thread is not None
                              and rep.thread.is_alive()):
                continue
            # (re-)spawn the worker: the router is restartable; the engines
            # (and their prefix caches) persist across serve() waves, only
            # the threads are per run
            while not rep.inbox.empty():     # stale _STOPs from stop()
                try:
                    rep.inbox.get_nowait()
                except queue.Empty:
                    break
            rep.error = None
            rep.engine.load_kernels()        # no tick waits on nvcc
            built = None
            if rep.engine.device.type == "cuda":
                if rep.stream is None:
                    rep.stream = torch.cuda.Stream(rep.engine.device)
                built = torch.cuda.Event()
                built.record(torch.cuda.current_stream(rep.engine.device))
            rep.thread = threading.Thread(target=rep._run, args=(built,),
                                          daemon=True,
                                          name=f"replica-{rep.idx}")
            rep.thread.start()
        self._monitor_task = asyncio.ensure_future(self._monitor())

    async def stop(self) -> None:
        """Stop and join every worker, then wait for each one's stream: a
        failed replica's worker may still be mid-tick on the card, and its
        pools must outlive that tick."""
        if not self._started:
            return
        if self._monitor_task is not None:
            self._monitor_task.cancel()
            self._monitor_task = None
        for rep in self.replicas:
            rep.inbox.put(_STOP)
        timeout = max(10.0, self.stall_timeout_s)
        for rep in self.replicas:
            if rep.thread is not None:
                rep.thread.join(timeout=timeout)
                if rep.thread.is_alive():
                    raise RuntimeError(
                        f"replica {rep.idx}'s worker did not stop within "
                        f"{timeout:g} s")
        self._started = False
        for rep in self.replicas:
            # the closure holds the router: left in place, the cycle would
            # keep the fleet's pools on the card after the router is dropped
            rep._post = None
            if rep.stream is not None:
                rep.stream.synchronize()

    async def _monitor(self):
        poll = min(0.05, self.stall_timeout_s / 4)
        while True:
            await asyncio.sleep(poll)
            for rep in self.replicas:
                if rep.failed:
                    continue
                if rep.error is not None:      # before its "died" event
                    self._on_died(rep.idx, 0, -1, rep.error)
                    continue
                dead = not rep.thread.is_alive()
                stalled = (rep.inflight > 0 and
                           time.monotonic() - rep.hb > self.stall_timeout_s)
                if dead or stalled:
                    self._handle_failure(
                        rep.idx, "died" if dead else
                        f"stalled (> {self.stall_timeout_s:g}s)")

    # -- dispatch -----------------------------------------------------------

    def _healthy(self) -> list[int]:
        return [r.idx for r in self.replicas if not r.failed]

    def _affinity_key(self, prompt: tuple) -> Optional[bytes]:
        """The leading page-aligned prompt tokens (the unit the radix
        prefix cache shares) as stable bytes, int64 little-endian as the
        reference hashes them; None when the prompt has no full page."""
        page = self.replicas[0].engine.config.page_size
        n_pages = min(len(prompt) // page, self.affinity_pages)
        if n_pages < 1:
            return None
        return np.asarray(prompt[:n_pages * page], "<i8").tobytes()

    def _rendezvous(self, key: bytes, candidates: list[int]) -> int:
        """Highest-random-weight hash: each replica scores the key (blake2b
        of the key and the replica's index); the highest wins, ties to the
        lowest index. Removing a replica remaps only *its* keys, which
        keeps warm prefix caches warm through membership churn."""
        def score(i: int) -> int:
            h = hashlib.blake2b(key + i.to_bytes(4, "little"),
                                digest_size=8).digest()
            return int.from_bytes(h, "little")
        return max(candidates, key=lambda i: (score(i), -i))

    def _least_loaded(self, candidates: list[int]) -> int:
        return min(candidates, key=lambda i: (self.replicas[i].load, i))

    def _choose(self, request: Request) -> Optional[int]:
        """Pick a replica with capacity, or None (caller awaits)."""
        healthy = self._healthy()
        if not healthy:
            raise ReplicaFailed("all replicas have failed")
        free = [i for i in healthy
                if self.replicas[i].inflight < self.max_inflight]
        if self.policy == "round-robin":
            i = healthy[self._rr % len(healthy)]
            self._rr += 1
            return i if self.replicas[i].inflight < self.max_inflight \
                else None
        if self.policy == "prefix":
            key = self._affinity_key(request.prompt)
            if key is not None:
                i = self._rendezvous(key, healthy)
                return i if self.replicas[i].inflight < self.max_inflight \
                    else None              # wait for the affine replica
        return self._least_loaded(free) if free else None

    async def submit(self, request: Request,
                     stream: Optional[Callable] = None) -> asyncio.Future:
        """Dispatch one ``api.Request``; returns a future resolving to its
        ``api.Completion``. ``stream(event: api.StreamEvent)`` fires in the
        event loop thread for every token (``event.replica`` names the
        serving replica; indices stay contiguous across a re-dispatch)."""
        if not self._started:
            await self.start()
        if not isinstance(request, Request):
            raise ApiValidationError(
                f"router.submit needs serve.api.Request, got "
                f"{type(request).__name__}")
        cfg = self.replicas[0].engine.config
        if request.sampling is not None and request.sampling != cfg.sampling:
            raise ApiValidationError(
                f"request.sampling={request.sampling} != the fleet's "
                f"sampling={cfg.sampling} — replicas share one "
                "EngineConfig.sampling")
        if request.request_id is None:
            rid = self._next_rid
        else:
            rid = int(request.request_id)
            if rid in self._inflight:
                raise ApiValidationError(
                    f"request_id {rid} is already in flight")
        self._next_rid = max(self._next_rid, rid) + 1
        self._m_requests.inc()
        inf = _Inflight(rid, request, self._loop.create_future(), stream)
        self._inflight[rid] = inf
        await self._dispatch(inf)
        return inf.future

    async def _dispatch(self, inf: _Inflight) -> None:
        while True:
            try:
                idx = self._choose(inf.request)
            except ReplicaFailed as e:
                if not inf.future.done():
                    inf.future.set_exception(e)
                self._inflight.pop(inf.rid, None)
                return
            if idx is not None:
                break
            self._m_backpressure.inc()
            self._cap_event.clear()
            await self._cap_event.wait()   # backpressure: wait for capacity
        rep = self.replicas[idx]
        inf.replica = idx
        rep.inflight += 1
        done_already = len(inf.generated)
        req = inf.request
        if done_already:                   # resume after a replica failure:
            req = Request(                 # re-prefill prompt + generated
                prompt=req.prompt + tuple(inf.generated),
                max_new_tokens=req.max_new_tokens - done_already,
                eos_id=req.eos_id, priority=req.priority,
                sampling=req.sampling, request_id=inf.rid)
        elif req.request_id != inf.rid:
            req = Request(prompt=req.prompt,
                          max_new_tokens=req.max_new_tokens,
                          eos_id=req.eos_id, priority=req.priority,
                          sampling=req.sampling, request_id=inf.rid)
        epoch = inf.epoch
        # a failed replica's engine keeps its unfinished requests, and so
        # this callback: a strong reference to the router would make a
        # cycle that keeps the fleet's pools on the card
        fleet = weakref.ref(self)

        def cb(ev: StreamEvent, _idx=idx, _epoch=epoch, _rid=inf.rid):
            # worker thread -> loop thread; stale epochs dropped there
            router = fleet()
            if router is None:
                return
            try:
                router._loop.call_soon_threadsafe(
                    router._on_token, _idx, _epoch, _rid, int(ev.token),
                    bool(ev.done))
            except RuntimeError:
                pass
        self._m_dispatches.inc(replica=str(idx))
        rep.inbox.put((req, cb, epoch))

    # -- event handlers (loop thread only) ----------------------------------

    def _live(self, idx: int, epoch: int, rid: int) -> Optional[_Inflight]:
        inf = self._inflight.get(rid)
        if inf is None or inf.epoch != epoch or inf.replica != idx:
            return None                    # stale: re-dispatched elsewhere
        return inf

    def _on_token(self, idx: int, epoch: int, rid: int, token: int,
                  done: bool) -> None:
        inf = self._live(idx, epoch, rid)
        if inf is None:
            return
        if inf.t_first is None:
            inf.t_first = time.perf_counter()
        index = len(inf.generated)
        inf.generated.append(token)
        rep = self.replicas[idx]
        rep._m_tokens.inc(replica=str(idx))
        if inf.stream is not None:
            inf.stream(StreamEvent(request_id=rid, token=token, index=index,
                                   done=done, replica=idx))
        if self._fail_after is not None and idx == self._fail_after[0] \
                and rep.n_tokens >= self._fail_after[1]:
            self._fail_after = None
            self._handle_failure(idx, "failure injected (fail_after)")

    def _on_done(self, idx: int, epoch: int, rid: int, rec: dict) -> None:
        inf = self._live(idx, epoch, rid)
        if inf is None:
            return
        self._finalize(inf, rec)

    def _on_error(self, idx: int, epoch: int, rid: int,
                  exc: BaseException) -> None:
        inf = self._live(idx, epoch, rid)
        if inf is None:
            return
        self.replicas[idx].inflight -= 1
        self._inflight.pop(rid, None)
        if not inf.future.done():
            inf.future.set_exception(exc)
        self._cap_event.set()

    def _on_died(self, idx: int, epoch: int, rid: int,
                 exc: BaseException) -> None:
        if _device_error(exc):
            self._fail_fleet(idx, exc)
            return
        self._handle_failure(idx, f"worker raised {type(exc).__name__}: "
                                  f"{exc}")

    def _finalize(self, inf: _Inflight, rec: Optional[dict]) -> None:
        rep = self.replicas[inf.replica]
        rep.inflight -= 1
        rep._m_done.inc(replica=str(inf.replica))
        completion = Completion(
            request_id=inf.rid, tokens=tuple(inf.generated),
            n_prompt=len(inf.request.prompt), priority=inf.request.priority,
            n_cached=rec["n_cached"] if rec else 0,
            n_preempted=rec["n_preempted"] if rec else 0,
            n_redispatched=inf.n_redispatched, replica=inf.replica,
            t_submit=inf.t_submit, t_first=inf.t_first,
            t_done=time.perf_counter())
        self._inflight.pop(inf.rid, None)
        self._completions.append(completion)
        if not inf.future.done():
            inf.future.set_result(completion)
        self._cap_event.set()

    # -- failure handling ---------------------------------------------------

    def fail_replica(self, idx: int, reason: str = "failure injected",
                     ) -> None:
        """Force replica ``idx`` down (test and benchmark hook: the same
        path the monitor takes for a crashed or stalled worker)."""
        self._handle_failure(idx, reason)

    def fail_replica_after(self, idx: int, n_tokens: int) -> None:
        """Arm a deterministic failure: replica ``idx`` is failed as soon
        as it has streamed ``n_tokens`` tokens (router-side count)."""
        self._fail_after = (int(idx), int(n_tokens))

    def _handle_failure(self, idx: int, reason: str) -> None:
        rep = self.replicas[idx]
        if rep.failed:
            return
        rep.failed = True
        self._m_failovers.inc()
        if not reason.startswith("failure injected"):
            log.warning("replica %d failed: %s", idx, reason)
        rep.inbox.put(_STOP)
        victims = [inf for inf in self._inflight.values()
                   if inf.replica == idx]
        for inf in victims:
            inf.epoch += 1                 # drop stale events from the old
            inf.n_redispatched += 1        # dispatch (worker may still run)
            rep.inflight -= 1
            eos_hit = (inf.request.eos_id is not None and inf.generated
                       and inf.generated[-1] == inf.request.eos_id)
            if len(inf.generated) >= inf.request.max_new_tokens or eos_hit:
                # finished, but the done event raced the failure: finalize
                rep.inflight += 1          # _finalize decrements
                inf.n_redispatched -= 1
                self._finalize(inf, None)
                continue
            self._m_redispatches.inc()
            task = asyncio.ensure_future(self._dispatch(inf))
            self._redispatches.add(task)
            task.add_done_callback(self._redispatches.discard)
        self._cap_event.set()

    def _fail_fleet(self, idx: int, exc: BaseException) -> None:
        """A CUDA error on replica ``idx``: the card may refuse every
        replica's work from now on, so every replica is failed and every
        pending request fails with it (nothing is re-dispatched)."""
        for rep in self.replicas:
            if not rep.failed:
                rep.failed = True
                self._m_failovers.inc()
                rep.inbox.put(_STOP)
        err = ReplicaFailed(f"replica {idx} hit a CUDA error, which may "
                            f"poison the device for every replica: {exc}")
        err.__cause__ = exc
        for inf in list(self._inflight.values()):
            if not inf.future.done():
                inf.future.set_exception(err)
        self._inflight.clear()
        self._cap_event.set()

    # -- fleet stats --------------------------------------------------------

    def fleet_stats(self, wall: Optional[float] = None,
                    completions: Optional[list] = None) -> dict:
        """Aggregate SLO stats (over ``completions`` when given, one
        serve() wave, else everything the router ever finished) plus
        per-replica counters (the per-replica ``prefix_hit_rate`` is what
        the affinity policy buys)."""
        comps = (completions if completions is not None
                 else self._completions)

        def slo(cs) -> dict:
            return slo_summary(
                (c.ttft_s for c in cs if c.ttft_s is not None),
                (c.latency_s for c in cs), len(cs),
                n_preempted=sum(c.n_preempted for c in cs),
                n_redispatched=sum(c.n_redispatched for c in cs))

        n_new = sum(c.n_generated for c in comps)
        stats = {
            "n_replicas": len(self.replicas),
            "n_failed_replicas": sum(r.failed for r in self.replicas),
            "policy": self.policy,
            "n_generated": int(n_new),
            "n_prompt": int(sum(c.n_prompt for c in comps)),
            "n_cached_tokens": int(sum(c.n_cached for c in comps)),
            **slo(comps),
            "by_class": {c: slo([x for x in comps if x.priority == c])
                         for c in sorted({x.priority for x in comps})},
            "per_replica": [
                {"replica": r.idx, "failed": r.failed,
                 "n_requests": r.n_done, "n_generated": r.n_tokens,
                 "n_ticks": r.engine.n_ticks,
                 "n_preemptions": r.engine.scheduler.n_preemptions,
                 "prefix_hit_rate": (r.engine.prefix_cache.hit_rate
                                     if r.engine.prefix_cache is not None
                                     else 0.0)}
                for r in self.replicas],
        }
        if wall is not None:
            stats["wall_s"] = wall
            stats["tok_s"] = n_new / wall if wall > 0 else 0.0
        return stats

    def to_prometheus(self) -> str:
        """One exposition page for the whole fleet: the router's own
        registry plus every replica engine's registry, the latter labelled
        with ``replica``."""
        parts = [self.metrics.to_prometheus()]
        parts += [r.engine.metrics.to_prometheus({"replica": r.idx})
                  for r in self.replicas]
        return "".join(parts)

    # -- sync convenience ---------------------------------------------------

    def serve(self, requests) -> dict:
        """Serve a batch to completion (sync wrapper): accepts the same
        request shapes as ``ServeEngine.run`` and returns the same
        ``{"results", "completions", "stats"}`` dict, with ``stats`` being
        ``fleet_stats``. Raises ``ReplicaFailed`` when the fleet cannot
        finish (every replica failed, or a CUDA error). Must not be called
        from inside an event loop."""
        return asyncio.run(self._serve(requests))

    async def _serve(self, requests) -> dict:
        reqs = []
        for r in requests:
            if isinstance(r, Request):
                reqs.append(r)
            elif isinstance(r, dict):
                reqs.append(Request(**r))
            else:
                prompt, gen = r
                reqs.append(Request(prompt=prompt, max_new_tokens=gen))
        await self.start()
        try:
            t0 = time.perf_counter()
            futs = [await self.submit(r) for r in reqs]
            completions = await asyncio.gather(*futs)
            wall = time.perf_counter() - t0
        finally:
            await self.stop()
        return {"results": {c.request_id: list(c.tokens)
                            for c in completions},
                "completions": list(completions),
                "stats": self.fleet_stats(wall, list(completions))}
