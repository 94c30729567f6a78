"""Typed metrics registry: counters, gauges, histograms, and ``TraceLog``.

A copy of ``repro.obs.metrics``. One process-global :class:`MetricsRegistry`
(module functions below) holds the port's accounting:

* **store** — ``store.hits`` / ``store.miss_bytes`` from the sharded
  embedding store's read path (``store/backend.py``);
* **serve** — ``serve.rejected.<reason>`` per typed admission rejection
  (``serve/server.py``);
* **set-up** — the gauges ``setup.normalize_s`` (``graph/formats.py``
  ``gcn_normalize``), ``setup.partition_s`` (``graph/partition.py``
  ``partition_graph``) and ``setup.trainer_s`` (the ``GNNTrainer``
  constructor): the seconds each last took, on the obs clock
  (:func:`timed`).

:class:`TraceLog` is kept as API: a list whose ``append`` also bumps
``retrace.<scope>`` and emits a ``retrace`` event. The JAX package appends
to one each time ``jit`` traces a step or a sweep; the port runs eagerly and
traces nothing, so no module of the port appends to one.

Unlike the span tracer, the registry is always on: a counter bump is one
dict lookup and an integer add on host code, and the accounting must not
vanish when tracing is off. :func:`reset_metrics` zeroes everything in
place (instruments are looked up by name at each seam, so no stale handle
survives a reset).

Pure stdlib; imports only :mod:`.spans`.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional

from . import spans as _spans


class Counter:
    """Monotonic counter (ints or floats)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n=1) -> None:
        self.value += n


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Streaming summary: count/sum/min/max (no buckets — the exporters
    report the summary, the trace carries the raw spans)."""

    __slots__ = ("count", "total", "min", "max")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)

    def summary(self) -> dict:
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max,
                "mean": self.total / self.count if self.count else 0.0}


class MetricsRegistry:
    """Name -> instrument maps, created on first touch, thread-safe."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def _get(self, table: dict, name: str, factory):
        inst = table.get(name)
        if inst is None:
            with self._lock:
                inst = table.setdefault(name, factory())
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._hists, name, Histogram)

    def reset(self) -> None:
        """Zero every instrument in place (names survive, values reset)."""
        with self._lock:
            for c in self._counters.values():
                c.value = 0
            for g in self._gauges.values():
                g.value = 0.0
            for h in self._hists.values():
                h.count, h.total, h.min, h.max = 0, 0.0, None, None

    def snapshot(self) -> dict:
        """Flat JSON-ready view: {"counters": {...}, "gauges": {...},
        "histograms": {name: summary}}. Zero-valued counters are kept — a
        zero is evidence the seam ran and saw nothing, absence is not."""
        return {
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {k: h.summary()
                           for k, h in sorted(self._hists.items())},
        }


REGISTRY = MetricsRegistry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


def count(name: str, n=1) -> None:
    """Bump a named counter (the one-line instrumentation seam)."""
    REGISTRY.counter(name).inc(n)


def observe(name: str, v) -> None:
    REGISTRY.histogram(name).observe(v)


def snapshot() -> dict:
    return REGISTRY.snapshot()


def reset_metrics() -> None:
    REGISTRY.reset()


@contextlib.contextmanager
def timed(name: str):
    """Time a block (or, as a decorator, a function) that runs once per
    process on the obs clock: its seconds go to the always-on gauge
    ``name``, and with tracing on it is also a host span of that name."""
    with _spans.span(name):
        t0 = _spans.clock()
        try:
            yield
        finally:
            REGISTRY.gauge(name).set(_spans.clock() - t0)


class TraceLog(list):
    """A list of retrace tags that also counts them.

    A real ``list`` — ``len``/``clear``/slicing/equality all behave — whose
    ``append`` additionally counts a ``retrace.<scope>`` metric and, when
    tracing is armed, emits a ``retrace`` instant event (the JAX package's
    step and sweep bodies append one per ``jit`` trace)."""

    def __init__(self, scope: str):
        super().__init__()
        self.scope = scope

    def append(self, tag) -> None:
        super().append(tag)
        REGISTRY.counter(f"retrace.{self.scope}").inc()
        _spans.event("retrace", {"scope": self.scope, "tag": str(tag)})
