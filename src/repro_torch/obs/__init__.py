"""Observability substrate of the port: tracing, latency histograms,
Prometheus text.

Stdlib only, like the reference's: ``repro_torch.core`` imports it from its
hottest paths, so nothing here may pull in torch, numpy or the service
layer. ``trace`` records spans, ``hist`` keeps log-bucket latency
histograms, ``prom`` renders a ``metrics()`` snapshot as Prometheus text and
``sanitize`` makes any snapshot strictly JSON-serializable. All four are
byte-for-byte copies of the JAX package's modules.
"""

from .hist import (  # noqa: F401
    BUCKET_BOUNDS_US,
    HistogramRegistry,
    LogHistogram,
    histogram_snapshots,
    observe,
    registry,
    reset_histograms,
)
from .prom import render_prometheus  # noqa: F401
from .sanitize import sanitize_snapshot  # noqa: F401
from .trace import (  # noqa: F401
    attach,
    capture,
    current_context,
    current_traceparent,
    disable_tracing,
    drain_spans,
    dump_trace,
    enable_tracing,
    parse_traceparent,
    recorded_spans,
    reset_tracing,
    span,
    spans_for,
    timed,
    tracing_enabled,
    tracing_stats,
)

__all__ = [
    "BUCKET_BOUNDS_US",
    "HistogramRegistry",
    "LogHistogram",
    "attach",
    "capture",
    "current_context",
    "current_traceparent",
    "disable_tracing",
    "drain_spans",
    "dump_trace",
    "enable_tracing",
    "histogram_snapshots",
    "observe",
    "parse_traceparent",
    "recorded_spans",
    "registry",
    "render_prometheus",
    "reset_histograms",
    "reset_tracing",
    "sanitize_snapshot",
    "span",
    "spans_for",
    "timed",
    "tracing_enabled",
    "tracing_stats",
]
