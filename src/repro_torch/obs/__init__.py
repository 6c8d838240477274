"""Telemetry for the port's serving engine: the metrics registry and the
request tracer, copies of ``repro.obs.metrics`` and ``repro.obs.trace``.

Everything defaults off (``NULL_REGISTRY`` / ``NULL_TRACER``) and the
disabled path is a no-op method call per site. ``obs.profile`` holds the
kernel and engine-tick ``Profiler`` (with its ``kernel_call`` hook) and the
training telemetry (``TrainTelemetry`` and the block-sparsity probes).
"""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricsRegistry, NULL_REGISTRY,
                                     NullRegistry, parse_prometheus, pct,
                                     prom_value, slo_summary)
from repro_torch.obs.profile import (Profiler, TrainTelemetry, active,
                                     group_l1_penalty, kernel_call,
                                     layer_block_sparsity,
                                     sparsity_telemetry_fn,
                                     total_block_sparsity)
from repro_torch.obs.trace import (NULL_TRACER, NullTracer, Tracer,
                                   validate_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "NullRegistry",
    "NULL_REGISTRY", "parse_prometheus", "pct", "prom_value", "slo_summary",
    "Tracer", "NullTracer", "NULL_TRACER", "validate_chrome_trace",
    "Profiler", "active", "kernel_call",
    "TrainTelemetry", "group_l1_penalty", "layer_block_sparsity",
    "sparsity_telemetry_fn", "total_block_sparsity",
]
