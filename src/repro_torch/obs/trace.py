"""The port's copy of ``repro.obs.trace``: the request lifecycle tracer —
a serve run as an openable timeline.

Emits Chrome trace-event JSON (the Perfetto / ``chrome://tracing`` on-disk
format): load the exported file in https://ui.perfetto.dev and every
request is a track showing exactly where its latency went.

Model:

* **One synthetic thread per request** (tid = submission order + 1), plus
  tid 0 for the engine itself. Thread-name metadata events label them
  ``request <rid>`` / ``engine``.
* **Lifecycle phases as complete ("X") spans** on the request's track:
  ``wait`` (submit -> admit, and again after every preemption, with
  ``resumed: true``), ``prefill`` (admit -> prompt done; ``prefill_chunk``
  instants mark each scheduled chunk), ``decode`` (first sample -> done).
  Exactly one phase is open per request at any time — ``phase()`` closes
  the previous span, so a preempt-requeue produces a *resumed* span chain,
  never an overlapping duplicate.
* **Instant ("i") markers** for the point events: ``submit``,
  ``first_token``, ``preempt``, ``done``.
* **Per-tick engine spans** on tid 0: each ``tick`` span nests a
  ``schedule`` (host-side planning) and ``step`` (jitted mixed step) child
  — Perfetto nests same-track spans by containment.

Timestamps are ``time.perf_counter`` microseconds relative to tracer
construction; the engine stamps scheduler events with the same clock, so
trace span durations reconcile with the stats dict's ttft/latency numbers
(tested to within a tick).

``NullTracer`` (shared ``NULL_TRACER``) is the disabled path: every hook
is an empty method and ``span()`` hands back one reusable no-op context
manager — tracing off costs a method call per site, nothing more.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Optional

ENGINE_TID = 0

# chrome trace-event keys every exported event must carry (the schema the
# tests validate against)
REQUIRED_KEYS = ("name", "ph", "ts", "pid", "tid")


class Tracer:
    """Collects events in memory; ``to_chrome()`` / ``save()`` export."""

    enabled = True

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._t0 = clock()
        self.events: list[dict] = []
        self._tids: dict[int, int] = {}        # rid -> tid
        self._open_phase: dict[int, tuple] = {}  # rid -> (name, t0_us, args)
        self._next_tid = 1
        self._tid_lock = threading.Lock()      # router replicas share one

    # -- clock --------------------------------------------------------------

    def now_us(self) -> int:
        return int((self._clock() - self._t0) * 1e6)

    def _tid(self, rid: int) -> int:
        tid = self._tids.get(rid)
        if tid is None:
            with self._tid_lock:
                tid = self._tids.get(rid)
                if tid is None:
                    tid = self._tids[rid] = self._next_tid
                    self._next_tid += 1
        return tid

    # -- raw event emitters -------------------------------------------------

    def _complete(self, name: str, cat: str, tid: int, ts: int, dur: int,
                  args: Optional[dict] = None) -> None:
        ev = {"name": name, "cat": cat, "ph": "X", "ts": ts,
              "dur": max(int(dur), 1), "pid": 0, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    def instant(self, name: str, tid: int = ENGINE_TID, cat: str = "engine",
                **args) -> None:
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": self.now_us(), "pid": 0, "tid": tid}
        if args:
            ev["args"] = args
        self.events.append(ev)

    @contextlib.contextmanager
    def span(self, name: str, tid: int = ENGINE_TID, cat: str = "engine",
             **args):
        """Engine-side timed span (tick / schedule / step)."""
        t0 = self.now_us()
        mutable = dict(args)
        try:
            yield mutable                    # caller may add result args
        finally:
            self._complete(name, cat, tid, t0, self.now_us() - t0, mutable)

    def complete_span(self, name: str, t0_us: int, tid: int = ENGINE_TID,
                      cat: str = "engine", **args) -> None:
        """Close a span opened by hand at ``t0_us = tracer.now_us()`` —
        for spans whose begin/end straddle an early-return (the engine's
        ``tick`` span, which is only emitted for non-idle ticks)."""
        self._complete(name, cat, tid, t0_us, self.now_us() - t0_us, args)

    # -- request lifecycle --------------------------------------------------

    def phase(self, rid: int, name: str, **args) -> None:
        """Switch request ``rid`` to lifecycle phase ``name``: closes the
        open phase span (if any) and opens the new one. No-op when already
        in that phase — per-token callers don't need their own edge
        detection."""
        tid = self._tid(rid)
        open_ = self._open_phase.get(rid)
        now = self.now_us()
        if open_ is not None:
            if open_[0] == name:
                return
            oname, t0, oargs = open_
            self._complete(oname, "request", tid, t0, now - t0, oargs)
        self._open_phase[rid] = (name, now, {"rid": rid, **args})

    def end_phases(self, rid: int) -> None:
        """Close the open phase (request finished)."""
        open_ = self._open_phase.pop(rid, None)
        if open_ is not None:
            name, t0, args = open_
            self._complete(name, "request", self._tid(rid), t0,
                           self.now_us() - t0, args)

    def request_submit(self, rid: int, priority: int, n_prompt: int) -> None:
        tid = self._tid(rid)
        self.instant("submit", tid=tid, cat="request", rid=rid,
                     priority=priority, n_prompt=n_prompt)
        self.phase(rid, "wait", priority=priority)

    def request_admit(self, rid: int, resumed: bool, n_cached: int) -> None:
        self.phase(rid, "prefill", resumed=resumed, n_cached=n_cached)

    def request_prefill_chunk(self, rid: int, n_tokens: int) -> None:
        self.instant("prefill_chunk", tid=self._tid(rid), cat="request",
                     rid=rid, n_tokens=n_tokens)

    def request_first_token(self, rid: int) -> None:
        self.instant("first_token", tid=self._tid(rid), cat="request",
                     rid=rid)

    def request_decode(self, rid: int) -> None:
        self.phase(rid, "decode")

    def request_preempt(self, rid: int) -> None:
        self.instant("preempt", tid=self._tid(rid), cat="request", rid=rid)
        self.phase(rid, "wait", resumed=True)

    def request_finish(self, rid: int) -> None:
        self.end_phases(rid)
        self.instant("done", tid=self._tid(rid), cat="request", rid=rid)

    # -- export -------------------------------------------------------------

    def to_chrome(self, process_name: str = "serve-engine") -> dict:
        """``{"traceEvents": [...], "displayTimeUnit": "ms"}`` with process/
        thread-name metadata and events sorted by (ts, tid) — the monotonic
        order Perfetto and the schema tests expect."""
        meta = [{"name": "process_name", "ph": "M", "ts": 0, "pid": 0,
                 "tid": 0, "args": {"name": process_name}},
                {"name": "thread_name", "ph": "M", "ts": 0, "pid": 0,
                 "tid": ENGINE_TID, "args": {"name": "engine"}}]
        for rid, tid in sorted(self._tids.items(), key=lambda kv: kv[1]):
            meta.append({"name": "thread_name", "ph": "M", "ts": 0,
                         "pid": 0, "tid": tid,
                         "args": {"name": f"request {rid}"}})
        # sort by ts; at equal ts the longer (parent) span comes first so
        # nesting renders deterministically
        body = sorted(self.events,
                      key=lambda e: (e["ts"], e["tid"], -e.get("dur", 0)))
        return {"traceEvents": meta + body, "displayTimeUnit": "ms"}

    def save(self, path: str, process_name: str = "serve-engine") -> None:
        with open(path, "w") as f:
            json.dump(self.to_chrome(process_name), f)
            f.write("\n")


class _NullCtx:
    def __enter__(self):
        return {}

    def __exit__(self, *a):
        return False


_NULL_CTX = _NullCtx()


class NullTracer:
    """The disabled tracer: every hook is a no-op (explicit methods — a
    typo'd hook name fails loudly instead of silently no-opping)."""

    enabled = False
    events: list = []

    def now_us(self) -> int:
        return 0

    def instant(self, *a, **k):
        pass

    def span(self, *a, **k):
        return _NULL_CTX

    def complete_span(self, *a, **k):
        pass

    def phase(self, *a, **k):
        pass

    def end_phases(self, *a, **k):
        pass

    def request_submit(self, *a, **k):
        pass

    def request_admit(self, *a, **k):
        pass

    def request_prefill_chunk(self, *a, **k):
        pass

    def request_first_token(self, *a, **k):
        pass

    def request_decode(self, *a, **k):
        pass

    def request_preempt(self, *a, **k):
        pass

    def request_finish(self, *a, **k):
        pass

    def to_chrome(self, process_name: str = "serve-engine") -> dict:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    def save(self, path: str, process_name: str = "serve-engine") -> None:
        pass


NULL_TRACER = NullTracer()


def validate_chrome_trace(doc: dict) -> list[dict]:
    """Schema check used by tests and the CI smoke: the document is a
    trace-event JSON object whose events all carry the required keys, "X"
    events carry ``dur``, and non-metadata timestamps are sorted. Returns
    the event list; raises ``ValueError`` on any violation."""
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        raise ValueError("not a chrome trace: missing 'traceEvents'")
    events = doc["traceEvents"]
    last_ts = None
    for i, ev in enumerate(events):
        for k in REQUIRED_KEYS:
            if k not in ev:
                raise ValueError(f"event {i} missing required key {k!r}: "
                                 f"{ev}")
        if ev["ph"] == "X" and "dur" not in ev:
            raise ValueError(f"complete event {i} missing 'dur': {ev}")
        if ev["ph"] == "M":
            continue
        if last_ts is not None and ev["ts"] < last_ts:
            raise ValueError(f"event {i} breaks ts monotonicity: "
                             f"{ev['ts']} < {last_ts}")
        last_ts = ev["ts"]
    return events
