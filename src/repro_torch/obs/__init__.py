"""Observability substrate of the port: spans and latency histograms.

Copies of ``hist`` and ``trace`` (stdlib only), so the ``_obs_trace`` spans
in the reader, the chunk fetcher and the decode engine keep working. The
Prometheus renderer and the snapshot sanitizer belong to the service tier
and arrive with it.
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
    "reset_histograms",
    "reset_tracing",
    "span",
    "spans_for",
    "timed",
    "tracing_enabled",
    "tracing_stats",
]
