"""Span/event tracer of the port: free when disabled, injectable clock.

A copy of ``repro.obs.spans`` (same names, same events). One process-global
:class:`Tracer` (armed by :func:`enable`, torn down by :func:`disable`)
collects **spans** (named intervals with a start and a duration) and
**instant events** into per-thread buffers. The spans the port emits:

* training — ``epoch > decide > step`` (``train/trainer.py``);
* serving — ``request > lookup`` on the request path, ``admit`` on submit,
  ``refresh > plan > sweep`` on the update path (``serve/server.py``,
  ``serve/engine.py``).

Rules:

* **disabled = free.** :func:`span` with no tracer armed returns one shared
  :data:`NULL_SPAN`: no allocation, no clock read. ``args`` is a positional
  optional (never ``**kwargs``) so the disabled call builds no dict.
* **host clock only.** A span reads the host clock at enter and exit and
  nothing else: it never synchronizes the device. PyTorch launches CUDA work
  asynchronously, so a span around kernel launches covers their enqueue, not
  their execution; work still running on the card at exit lands in whichever
  later span first waits for it (a copy to the host, ``float(loss)``).
  Tracing on or off leaves every launch and every result unchanged.
* **injectable clock.** Every timestamp comes from the tracer's monotonic
  ``clock`` (default ``time.perf_counter``); :class:`FakeClock` substitutes a
  deterministic one for tests, with a ``sleep`` that advances fake time so
  the load generators idle without real waits.

Thread safety: each thread appends to its own buffer (created under a lock,
appended to lock-free — ``list.append`` is atomic under the GIL);
:func:`drain` merges and time-sorts all buffers.

Pure stdlib: every layer of the port may import it without cycles.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Optional


class _NullSpan:
    """The disabled-tracer span: a shared, stateless context manager."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NULL_SPAN = _NullSpan()


class _Span:
    """One live span: clocks itself on enter/exit, records on exit."""

    __slots__ = ("_tracer", "name", "args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.args = args

    def __enter__(self) -> "_Span":
        self._t0 = self._tracer.clock()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = self._tracer.clock()
        self._tracer._record(self.name, self._t0, t1 - self._t0, self.args)
        return False


class FakeClock:
    """Deterministic injectable clock for tests.

    Calling it returns the current fake time; ``sleep`` advances it (so code
    that idles via ``clock.sleep`` makes progress without wall waits);
    ``advance`` moves it explicitly. ``tick`` (optional) auto-advances every
    read, guaranteeing strictly increasing stamps for code that polls."""

    def __init__(self, start: float = 0.0, tick: float = 0.0):
        self.t = float(start)
        self.tick = float(tick)

    def __call__(self) -> float:
        now = self.t
        self.t += self.tick
        return now

    def sleep(self, seconds: float) -> None:
        self.t += max(float(seconds), 0.0)

    def advance(self, seconds: float) -> None:
        self.t += float(seconds)


class Tracer:
    """Span/event collector with per-thread buffers and an injectable clock.

    Events are dicts in the Chrome ``trace_event`` shape (``ph``: ``"X"`` =
    complete span, ``"i"`` = instant), timestamps in *seconds* on the
    tracer's clock — :mod:`.export` converts to the format's µs."""

    def __init__(self, clock: Optional[Callable[[], float]] = None):
        self.clock: Callable[[], float] = \
            clock if clock is not None else time.perf_counter
        self._lock = threading.Lock()
        self._buffers: dict[int, list[dict]] = {}

    def _buf(self) -> list[dict]:
        tid = threading.get_ident()
        buf = self._buffers.get(tid)
        if buf is None:
            with self._lock:
                buf = self._buffers.setdefault(tid, [])
        return buf

    def _record(self, name: str, ts: float, dur: float,
                args: Optional[dict]) -> None:
        ev: dict[str, Any] = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._buf().append(ev)

    def span(self, name: str, args: Optional[dict] = None) -> _Span:
        return _Span(self, name, args)

    def event(self, name: str, args: Optional[dict] = None) -> None:
        ev: dict[str, Any] = {"name": name, "ph": "i", "ts": self.clock(),
                              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        self._buf().append(ev)

    def drain(self) -> list[dict]:
        """All recorded events, merged across threads and time-sorted;
        buffers are cleared."""
        with self._lock:
            bufs = list(self._buffers.values())
            self._buffers = {}
        out = [ev for buf in bufs for ev in buf]
        out.sort(key=lambda e: e["ts"])
        return out


# ---------------------------------------------------------------------------
# the process-global tracer (module functions are the instrumentation API)
# ---------------------------------------------------------------------------
_TRACER: Optional[Tracer] = None


def enable(clock: Optional[Callable[[], float]] = None) -> Tracer:
    """Arm tracing (replacing any active tracer). Returns the new tracer."""
    global _TRACER
    _TRACER = Tracer(clock=clock)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def current() -> Optional[Tracer]:
    return _TRACER


def span(name: str, args: Optional[dict] = None):
    """A span context manager — :data:`NULL_SPAN` when tracing is off (the
    allocation-free hot path)."""
    t = _TRACER
    return t.span(name, args) if t is not None else NULL_SPAN


def event(name: str, args: Optional[dict] = None) -> None:
    """Record an instant event; a no-op when tracing is off."""
    t = _TRACER
    if t is not None:
        t.event(name, args)


def clock() -> float:
    """The observability clock: the active tracer's (injectable,
    deterministic under :class:`FakeClock`) or ``time.perf_counter``.
    The port's engine, trainer, server and load generators read time
    through this, never ``time.perf_counter`` directly."""
    t = _TRACER
    return t.clock() if t is not None else time.perf_counter()


def drain() -> list[dict]:
    """Drain the active tracer's events ([] when tracing is off)."""
    t = _TRACER
    return t.drain() if t is not None else []
