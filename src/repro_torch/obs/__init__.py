"""repro_torch.obs — tracing, metrics and timeline export of the port.

A copy of ``repro.obs`` with the same API and file formats, in three
stdlib-only pieces (no torch, no other import of the port, so every layer
may depend on this one):

* :mod:`.spans` — the span/event tracer, free when disabled, with an
  injectable monotonic clock (arm with :func:`enable`, read time through
  :func:`clock`); spans read the host clock and never synchronize the card;
* :mod:`.metrics` — the always-on counter/gauge/histogram registry and the
  :class:`TraceLog` list;
* :mod:`.export` — Chrome/Perfetto ``trace_event`` JSON and flat metrics
  JSON writers, rendered by
  ``python -m repro_torch.obs summarize|timeline|diff``.
"""
from .spans import (  # noqa: F401
    NULL_SPAN,
    FakeClock,
    Tracer,
    clock,
    current,
    disable,
    drain,
    enable,
    enabled,
    event,
    span,
)
from .metrics import (  # noqa: F401
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    TraceLog,
    count,
    counter,
    gauge,
    histogram,
    observe,
    reset_metrics,
    snapshot,
)
from .export import (  # noqa: F401
    default_obs_dir,
    modeled_vs_measured,
    write_metrics,
    write_trace,
)

__all__ = [
    "NULL_SPAN", "FakeClock", "Tracer",
    "clock", "current", "disable", "drain", "enable", "enabled", "event",
    "span",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceLog", "count", "counter", "gauge", "histogram", "observe",
    "reset_metrics", "snapshot",
    "default_obs_dir", "modeled_vs_measured", "write_metrics", "write_trace",
]
