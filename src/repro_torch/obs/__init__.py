"""Telemetry for the port's serving engine: the metrics registry and the
request tracer, copies of ``repro.obs.metrics`` and ``repro.obs.trace``.

Everything defaults off (``NULL_REGISTRY`` / ``NULL_TRACER``) and the
disabled path is a no-op method call per site. ``obs.profile`` holds the
training telemetry (``TrainTelemetry`` and the block-sparsity probes); the
kernel profiler of ``repro.obs.profile`` comes with ROADMAP Queue 1 item 8b.
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_REGISTRY,
                                     NullRegistry, parse_prometheus, pct,
                                     prom_value, slo_summary)
from repro_torch.obs.profile import (TrainTelemetry, group_l1_penalty,
                                     layer_block_sparsity,
                                     sparsity_telemetry_fn,
                                     total_block_sparsity)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "parse_prometheus", "pct", "prom_value", "slo_summary",
    "Tracer", "NullTracer", "NULL_TRACER", "validate_chrome_trace",
    "TrainTelemetry", "group_l1_penalty", "layer_block_sparsity",
    "sparsity_telemetry_fn", "total_block_sparsity",
]
