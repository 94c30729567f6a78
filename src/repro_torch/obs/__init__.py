"""repro_torch.obs — tracing, metrics and timeline export of the port.

A copy of ``repro.obs`` with the same API and file formats, in three
stdlib-only pieces (no torch at import, no other import of the port, so
every layer may depend on this one), and a fourth loaded on demand:

* :mod:`.spans` — the span/event tracer, free when disabled, with an
  injectable monotonic clock (arm with :func:`enable`, read time through
  :func:`clock`); spans read the host clock, and those given a device are
  also timed on it and drained with ``dts`` / ``ddur`` on the host clock.
  The port's spans: ``epoch > decide > step > wait``, ``halo`` at every
  exchange site and direction, ``agg`` at every aggregation, the set-up's
  ``setup.normalize_s`` / ``setup.partition_s`` / ``setup.trainer_s`` (also
  always-on gauges), and the serving path's ``request > lookup``, ``admit``,
  ``refresh > plan > sweep`` (``halo`` and ``agg`` inside the sweep);
* :mod:`.device` — the device clock of CUDA devices (CUDA timing events),
  imported at the first span given one;
* :mod:`.metrics` — the always-on counter/gauge/histogram registry and the
  :class:`TraceLog` list;
* :mod:`.export` — Chrome/Perfetto ``trace_event`` JSON (device intervals
  on a track of their own) and flat metrics JSON writers, rendered by
  ``python -m repro_torch.obs summarize|timeline|diff``.
"""
from .spans import (  # noqa: F401
    NULL_SPAN,
    FakeClock,
    FakeDeviceClock,
    Tracer,
    add_arg,
    anchor,
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
    timed,
)
from .export import (  # noqa: F401
    default_obs_dir,
    modeled_vs_measured,
    write_metrics,
    write_trace,
)

__all__ = [
    "NULL_SPAN", "FakeClock", "FakeDeviceClock", "Tracer",
    "add_arg", "anchor", "clock", "current", "disable", "drain", "enable", "enabled", "event",
    "span",
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "TraceLog", "count", "counter", "gauge", "histogram", "observe",
    "reset_metrics", "snapshot", "timed",
    "default_obs_dir", "modeled_vs_measured", "write_metrics", "write_trace",
]
