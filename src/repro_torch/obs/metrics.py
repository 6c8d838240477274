"""The port's copy of ``repro.obs.metrics``: a dependency-free live
metrics registry (counters / gauges / histograms).

The serving stack's visibility used to end at two ad-hoc end-of-run stats
dicts (``ServeEngine._stats``, ``Router.fleet_stats``). This module is the
single source of truth those dicts now read *from*: every load-bearing site
— scheduler admissions/preemptions/famine ticks, page-allocator occupancy
and free-list churn, prefix-cache hits/evictions/COW copies, per-tick token
budget utilization and compiled-width counts, router dispatch/backpressure/
failover, sampler batch sizes — increments a registry instrument instead of
a private counter, and the same numbers export as a JSON snapshot
(``MetricsRegistry.snapshot``) or Prometheus text exposition
(``MetricsRegistry.to_prometheus``).

Design constraints:

* **Dependency-free.** stdlib + numpy only (numpy is already a hard repo
  dependency); no prometheus_client, no opentelemetry.
* **Hot-path cheap.** An unlabeled ``Counter.inc()`` is one dict lookup +
  int add — the same cost as the private ``self.n_x += 1`` counters it
  replaces. Label resolution only happens on labeled instruments.
* **Zero-overhead off switch.** ``NULL_REGISTRY`` hands out a shared
  no-op instrument: every ``inc``/``set``/``observe`` is an empty method,
  ``value()`` reads 0, exports are empty. Components take a registry
  parameter and default to a live one (stats need real values), but the
  whole stack runs against ``NULL_REGISTRY`` — the overhead-guard tests
  hold the no-op path to noise.
* **Histograms are bounded.** Each series keeps exact count/sum/min/max
  plus a fixed-size reservoir of recent observations for percentile
  queries — a week-long serve run cannot grow the registry unboundedly.

Prometheus exposition notes: counters export as ``counter``, gauges as
``gauge``, histograms as the ``summary`` type (``{quantile="0.5"}`` /
``{quantile="0.95"}`` series from the reservoir plus exact ``_sum`` /
``_count``) — everything a text-format scraper accepts.
``parse_prometheus`` is the matching round-trip reader used by tests and
the CI smoke to assert the exposition actually parses.

The shared percentile/SLO helpers live here too (``pct``,
``slo_summary``) — previously duplicated between ``serve/engine.py`` and
``serve/router.py`` with an empty-list bug: percentiles of ``[]`` are
``None`` here, never a crash and never a fake ``0.0``.
"""
from __future__ import annotations

import json
import re
from typing import Iterable, Optional

import numpy as np

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


# ---------------------------------------------------------------------------
# shared percentile / SLO summary helpers (deduped from engine + router)
# ---------------------------------------------------------------------------

def pct(xs, q) -> Optional[float]:
    """Percentile ``q`` of ``xs`` — ``None`` for an empty sequence (an
    empty completions list must not crash ``np.percentile`` or report a
    fabricated 0.0 latency)."""
    xs = list(xs)
    if not xs:
        return None
    return float(np.percentile(xs, q))


def slo_summary(ttft: Iterable[float], latency: Iterable[float],
                n_requests: int, **extra) -> dict:
    """The SLO block shared by ``ServeEngine._stats`` and
    ``Router.fleet_stats``: p50/p95 TTFT + end-to-end latency (``None``
    when the record set is empty) plus caller-specific counters via
    ``extra`` (``n_preempted``, ``n_redispatched``, ...)."""
    ttft = list(ttft)
    latency = list(latency)
    return {
        "n_requests": int(n_requests),
        **extra,
        "ttft_p50_s": pct(ttft, 50), "ttft_p95_s": pct(ttft, 95),
        "latency_p50_s": pct(latency, 50), "latency_p95_s": pct(latency, 95),
    }


# ---------------------------------------------------------------------------
# instruments
# ---------------------------------------------------------------------------

class _Metric:
    """Base: one named instrument holding labeled series. The series key is
    the tuple of label values in ``labelnames`` order; unlabeled
    instruments use the empty tuple (one dict lookup on the hot path)."""

    kind = ""

    def __init__(self, name: str, help: str = "",
                 labelnames: tuple = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series: dict = {}

    def _key(self, labels: dict) -> tuple:
        if not self.labelnames:
            if labels:
                raise ValueError(f"{self.name} takes no labels, got {labels}")
            return ()
        try:
            return tuple(str(labels[n]) for n in self.labelnames)
        except KeyError as e:
            raise ValueError(f"{self.name} needs labels "
                             f"{self.labelnames}, got {tuple(labels)}") from e

    def series(self) -> list[tuple[dict, object]]:
        """[(labels dict, series state), ...] in insertion order."""
        return [(dict(zip(self.labelnames, k)), v)
                for k, v in self._series.items()]


class Counter(_Metric):
    """Monotonically increasing count."""

    kind = "counter"

    def inc(self, amount: float = 1, **labels) -> None:
        if amount < 0:
            raise ValueError(f"{self.name}: counters only go up ({amount})")
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0) + amount

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0)

    def total(self) -> float:
        """Sum over every labeled series."""
        return sum(self._series.values())


class Gauge(_Metric):
    """Point-in-time value (set, or add signed deltas)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[self._key(labels)] = value

    def add(self, delta: float, **labels) -> None:
        k = self._key(labels)
        self._series[k] = self._series.get(k, 0) + delta

    def value(self, **labels) -> float:
        return self._series.get(self._key(labels), 0)


class _HistSeries:
    """Exact count/sum/min/max + a bounded ring of recent observations
    (percentiles are over the window — bounded memory by construction)."""

    __slots__ = ("count", "sum", "min", "max", "samples", "_i", "_cap")

    def __init__(self, cap: int):
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self.samples: list[float] = []
        self._i = 0
        self._cap = cap

    def observe(self, v: float) -> None:
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self.samples) < self._cap:
            self.samples.append(v)
        else:                              # ring: overwrite oldest
            self.samples[self._i] = v
            self._i = (self._i + 1) % self._cap


class Histogram(_Metric):
    """Value distribution: exact count/sum/min/max, windowed percentiles."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", labelnames: tuple = (),
                 max_samples: int = 4096):
        super().__init__(name, help, labelnames)
        self.max_samples = int(max_samples)

    def observe(self, value: float, **labels) -> None:
        k = self._key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = _HistSeries(self.max_samples)
        s.observe(float(value))

    def count(self, **labels) -> int:
        s = self._series.get(self._key(labels))
        return s.count if s else 0

    def sum(self, **labels) -> float:
        s = self._series.get(self._key(labels))
        return s.sum if s else 0.0

    def percentile(self, q: float, **labels) -> Optional[float]:
        s = self._series.get(self._key(labels))
        return pct(s.samples, q) if s else None


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------

class MetricsRegistry:
    """Get-or-create registry: the same (name, kind, labelnames) always
    resolves to the same instrument, so every component can bind its
    instruments at construction and share the registry freely."""

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, labelnames: tuple, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls) or m.labelnames != tuple(labelnames):
                raise ValueError(
                    f"metric {name!r} re-registered as {cls.kind} "
                    f"labels={tuple(labelnames)} but exists as {m.kind} "
                    f"labels={m.labelnames}")
            return m
        m = cls(name, help, tuple(labelnames), **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "",
                labelnames: tuple = ()) -> Counter:
        return self._get(Counter, name, help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: tuple = ()) -> Gauge:
        return self._get(Gauge, name, help, labelnames)

    def histogram(self, name: str, help: str = "", labelnames: tuple = (),
                  max_samples: int = 4096) -> Histogram:
        return self._get(Histogram, name, help, labelnames,
                         max_samples=max_samples)

    def get(self, name: str) -> Optional[_Metric]:
        return self._metrics.get(name)

    # -- export -------------------------------------------------------------

    def snapshot(self) -> dict:
        """JSON-safe dump: ``{name: {"type", "help", "series": [...]}}``.
        Histogram series carry count/sum/min/max/p50/p95/p99."""
        out = {}
        for name, m in self._metrics.items():
            rows = []
            for labels, s in m.series():
                if m.kind == "histogram":
                    rows.append({"labels": labels, "count": s.count,
                                 "sum": s.sum, "min": s.min, "max": s.max,
                                 "p50": pct(s.samples, 50),
                                 "p95": pct(s.samples, 95),
                                 "p99": pct(s.samples, 99)})
                else:
                    rows.append({"labels": labels, "value": s})
            out[name] = {"type": m.kind, "help": m.help, "series": rows}
        return out

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)
            f.write("\n")

    def to_prometheus(self, extra_labels: Optional[dict] = None) -> str:
        """Prometheus text exposition (0.0.4). ``extra_labels`` are merged
        into every series — the router exports N replica registries into
        one page with ``{"replica": i}``."""
        extra = dict(extra_labels or {})
        lines: list[str] = []
        for name, m in self._metrics.items():
            if m.help:
                lines.append(f"# HELP {name} {_esc_help(m.help)}")
            kind = "summary" if m.kind == "histogram" else m.kind
            lines.append(f"# TYPE {name} {kind}")
            for labels, s in m.series():
                merged = {**extra, **labels}
                if m.kind == "histogram":
                    for q in (0.5, 0.95, 0.99):
                        v = pct(s.samples, q * 100)
                        if v is not None:
                            lines.append(_sample(
                                name, {**merged, "quantile": str(q)}, v))
                    lines.append(_sample(f"{name}_sum", merged, s.sum))
                    lines.append(_sample(f"{name}_count", merged, s.count))
                else:
                    lines.append(_sample(name, merged, s))
        return "\n".join(lines) + "\n"

    def save_prometheus(self, path: str,
                        extra_labels: Optional[dict] = None) -> None:
        with open(path, "w") as f:
            f.write(self.to_prometheus(extra_labels))


def _esc_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _esc_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _sample(name: str, labels: dict, value) -> str:
    label_s = ""
    if labels:
        inner = ",".join(f'{k}="{_esc_label(str(v))}"'
                         for k, v in labels.items())
        label_s = "{" + inner + "}"
    if value is None:
        value = float("nan")
    return f"{name}{label_s} {float(value):g}"


# ---------------------------------------------------------------------------
# the no-op registry (the disabled path must cost nothing)
# ---------------------------------------------------------------------------

class _NullMetric:
    """Accepts every instrument call, stores nothing, reads as empty."""

    def inc(self, *a, **k):
        pass

    def set(self, *a, **k):
        pass

    def add(self, *a, **k):
        pass

    def observe(self, *a, **k):
        pass

    def value(self, *a, **k):
        return 0

    def total(self):
        return 0

    def count(self, *a, **k):
        return 0

    def sum(self, *a, **k):
        return 0.0

    def percentile(self, *a, **k):
        return None


_NULL_METRIC = _NullMetric()


class NullRegistry:
    """Shared no-op: every instrument is the same ``_NullMetric``, exports
    are empty. Pass ``NULL_REGISTRY`` to strip telemetry entirely (stats
    counters then read 0 — the stats *structure* still works)."""

    def counter(self, *a, **k) -> _NullMetric:
        return _NULL_METRIC

    def gauge(self, *a, **k) -> _NullMetric:
        return _NULL_METRIC

    def histogram(self, *a, **k) -> _NullMetric:
        return _NULL_METRIC

    def get(self, name):
        return None

    def snapshot(self) -> dict:
        return {}

    def to_prometheus(self, extra_labels=None) -> str:
        return ""

    def save_json(self, path: str) -> None:
        pass

    def save_prometheus(self, path: str, extra_labels=None) -> None:
        pass


NULL_REGISTRY = NullRegistry()


# ---------------------------------------------------------------------------
# exposition round-trip (tests + CI smoke)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")
_LABEL_PAIR_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def parse_prometheus(text: str) -> dict:
    """Strict-enough text-format reader: returns
    ``{(name, (("label", "value"), ...)): float}``. Raises ``ValueError``
    on any line that is neither a comment nor a valid sample — the CI
    smoke's 'the exposition actually parses' assertion."""
    out: dict = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise ValueError(f"line {ln}: not a prometheus sample: {line!r}")
        labels = tuple(sorted(
            (k, v.replace('\\"', '"').replace("\\\\", "\\"))
            for k, v in _LABEL_PAIR_RE.findall(m.group("labels") or "")))
        out[(m.group("name"), labels)] = float(m.group("value"))
    return out


def prom_value(parsed: dict, name: str, **labels) -> Optional[float]:
    """Sum of every parsed series of ``name`` matching the given label
    subset (label-free query sums the whole family)."""
    want = {k: str(v) for k, v in labels.items()}
    total, seen = 0.0, False
    for (n, lab), v in parsed.items():
        if n != name:
            continue
        lab = dict(lab)
        if all(lab.get(k) == s for k, s in want.items()):
            total += v
            seen = True
    return total if seen else None
