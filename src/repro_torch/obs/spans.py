"""Span/event tracer of the port: free when disabled, injectable clocks.

A copy of ``repro.obs.spans`` (same names, same events) that can also time
a span on the device. One process-global :class:`Tracer` (armed by
:func:`enable`, torn down by :func:`disable`) collects **spans** (named
intervals with a start and a duration) and **instant events** into
per-thread buffers. The spans the port emits:

* training — ``epoch > decide > step > wait`` (``train/trainer.py``; ``wait``
  is the loss's sync); inside ``step``, ``halo`` at every exchange site and
  direction (``core/sylvie.py``, ``dist/overlap.py``, ``faults/comm.py``;
  args ``site``, ``dir``, ``kind`` (the exchange's path, not its
  precision), ``bytes``) and ``agg`` at every
  aggregation and its backward (``models/gnn/blocks.py``; args ``dir``,
  ``width``), both timed on the device;
* set-up — ``setup.normalize_s``, ``setup.partition_s``, ``setup.trainer_s``
  (``graph/formats.py``, ``graph/partition.py``, the trainer's constructor),
  beside the always-on gauges of the same names;
* serving — ``request > lookup`` on the request path, ``admit`` on submit,
  ``refresh > plan > sweep`` on the update path (``serve/server.py``,
  ``serve/engine.py``).

Rules:

* **disabled = free.** :func:`span` with no tracer armed returns one shared
  :data:`NULL_SPAN`: no allocation, no clock read, no device event. ``args``
  is a positional optional (never ``**kwargs``), and the instrumented sites
  check :func:`enabled` before they build one, so the disabled call builds
  no dict.
* **host clock, and device time on it.** A span reads the host clock at
  enter and exit. PyTorch launches CUDA work asynchronously, so that covers
  the work's enqueue, not its execution. A span given a ``device`` that the
  tracer's device clock times also records a timing event on the device's
  current stream at enter and exit (CUDA events, :mod:`.device`, loaded at
  the first such span). :func:`drain` puts them on the host clock through
  anchors, device events recorded on an idle stream at a known host time:
  one at the first device span, after a synchronize (the one synchronize
  added while the spans run; the work in front of it is what the span
  would wait for), and one wherever the program calls :func:`anchor` right
  after it has waited for the card itself (the trainer, after each loss's
  sync), so that the device clock's drift against the host's does not
  build up over a run; the drain waits for the marks to complete. A
  drained device span carries ``dts`` / ``ddur`` (seconds, host clock)
  beside ``ts`` / ``dur``. Tracing on or off leaves every launch and every
  result unchanged.
* **nesting by host time.** A span is inside another when its host interval
  is; an autograd backward's spans end before ``autograd.grad`` returns, so
  that holds across its thread too.
* **injectable clocks.** Every host timestamp comes from the tracer's
  monotonic ``clock`` (default ``time.perf_counter``); :class:`FakeClock`
  substitutes a deterministic one for tests, with a ``sleep`` that advances
  fake time so the load generators idle without real waits.
  :class:`FakeDeviceClock` stands in for the card's.

Thread safety: each thread appends to its own buffer (created under a lock,
appended to lock-free — ``list.append`` is atomic under the GIL);
:func:`drain` merges and time-sorts all buffers.

Pure stdlib at import: every layer of the port may import it without
cycles.
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
    """One live span: clocks itself on enter/exit (on the device too when
    it has a device timer), records on exit."""

    __slots__ = ("_tracer", "name", "args", "_timer", "_device", "_t0",
                 "_m0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict],
                 timer: Optional["DeviceTimer"] = None, device=None):
        self._tracer = tracer
        self.name = name
        self.args = args
        self._timer = timer
        self._device = device

    def __enter__(self) -> "_Span":
        self._tracer._open().append(self)
        self._t0 = self._tracer.clock()
        if self._timer is not None:
            self._m0 = self._timer.record(self._device)
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        marks = None
        if self._timer is not None:
            marks = (self._timer, self._m0, self._timer.record(self._device))
        t1 = tr.clock()
        tr._open().pop()
        tr._record(self.name, self._t0, t1 - self._t0, self.args, marks)
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


class FakeDeviceClock:
    """Deterministic device clock for tests, the device side of
    :class:`FakeClock` ``host``: a mark reads ``offset + rate * (host time
    + lag)``, a device ``lag`` seconds behind the host whose clock runs at
    ``rate`` against it; a synchronize advances the host by the lag. It
    times the devices whose ``type`` (or the string itself) is in
    ``types``, and counts its marks and synchronizes."""

    def __init__(self, host: FakeClock, offset: float = 0.0,
                 rate: float = 1.0, types=("cpu",)):
        self.host = host
        self.offset = float(offset)
        self.rate = float(rate)
        self.types = tuple(types)
        self.lag = 0.0
        self.marks = 0
        self.syncs = 0

    def times(self, device) -> bool:
        return getattr(device, "type", device) in self.types

    def key(self, device) -> str:
        return str(getattr(device, "type", device))

    def synchronize(self, device) -> None:
        """The host waits out the device's lag."""
        self.syncs += 1
        self.host.advance(self.lag)
        self.lag = 0.0

    def record(self, device) -> float:
        self.marks += 1
        return self.offset + self.rate * (self.host.t + self.lag)

    def elapsed(self, a: float, b: float) -> float:
        return b - a


class DeviceTimer:
    """Device marks put on the host clock. ``device_clock`` makes the marks:
    ``times(device)``, ``key(device)`` (one per physical device),
    ``synchronize(device)``, ``record(device) -> mark`` and ``elapsed(a, b)
    -> seconds``. An anchor is a mark recorded on an idle device at a known
    host time; a mark resolves from its device's latest anchor before it,
    ``host = h + elapsed(anchor, mark)``. A device's first mark is preceded
    by an anchor taken after a synchronize; :meth:`anchor` adds one where
    the caller has just waited for the device, with no synchronize, so that
    a device clock running at another rate than the host's drifts from it
    only until the next."""

    def __init__(self, clock: Callable[[], float], device_clock):
        self.clock = clock
        self.dev = device_clock
        self._lock = threading.Lock()
        self._anchors: dict = {}      # device key -> [(host s, mark)]
        self._devices: dict = {}      # device key -> device

    def _take(self, device, synchronize: bool) -> None:
        if synchronize:
            self.dev.synchronize(device)
        # the host clock read right after the mark is submitted: a pause
        # before it (making the mark, a collection) must not come between
        mark = self.dev.record(device)
        key = self.dev.key(device)
        self._anchors.setdefault(key, []).append((self.clock(), mark))
        self._devices[key] = device

    def anchor(self, device) -> None:
        with self._lock:
            self._take(device, synchronize=False)

    def record(self, device):
        key = self.dev.key(device)
        if key not in self._anchors:
            with self._lock:
                if key not in self._anchors:
                    self._take(device, synchronize=True)
        return key, len(self._anchors[key]) - 1, self.dev.record(device)

    def resolve(self, marks: list) -> list:
        """Host seconds of each ``(key, anchor index, mark)``; first waits
        for every device that has marks (a synchronize each, so that all
        have completed)."""
        for key in {k for k, _, _ in marks}:
            self.dev.synchronize(self._devices[key])
        out = []
        for key, i, m in marks:
            h, a = self._anchors[key][i]
            out.append(h + self.dev.elapsed(a, m))
        return out


class Tracer:
    """Span/event collector with per-thread buffers and injectable clocks.

    Events are dicts in the Chrome ``trace_event`` shape (``ph``: ``"X"`` =
    complete span, ``"i"`` = instant), timestamps in *seconds* on the
    tracer's clock — :mod:`.export` converts to the format's µs.
    ``device_clock`` (see :class:`DeviceTimer`; default: CUDA events, for
    CUDA devices) times the spans given a device."""

    def __init__(self, clock: Optional[Callable[[], float]] = None,
                 device_clock=None):
        self.clock: Callable[[], float] = \
            clock if clock is not None else time.perf_counter
        self.device_clock = device_clock
        self._timer: Optional[DeviceTimer] = None
        self._lock = threading.Lock()
        self._buffers: dict[int, list[dict]] = {}
        self._local = threading.local()

    def _open(self) -> list:
        """This thread's open spans, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _device_timer(self, device) -> Optional[DeviceTimer]:
        """The timer of ``device``'s spans, or ``None`` where the device
        clock does not time it."""
        if self.device_clock is None:
            if getattr(device, "type", None) != "cuda":
                return None
            from .device import CudaClock
            self.device_clock = CudaClock()
        if not self.device_clock.times(device):
            return None
        if self._timer is None:
            self._timer = DeviceTimer(self.clock, self.device_clock)
        return self._timer

    def _buf(self) -> list[dict]:
        tid = threading.get_ident()
        buf = self._buffers.get(tid)
        if buf is None:
            with self._lock:
                buf = self._buffers.setdefault(tid, [])
        return buf

    def _record(self, name: str, ts: float, dur: float,
                args: Optional[dict], marks=None) -> None:
        ev: dict[str, Any] = {"name": name, "ph": "X", "ts": ts, "dur": dur,
                              "tid": threading.get_ident()}
        if args:
            ev["args"] = args
        if marks is not None:
            ev["_marks"] = marks
        self._buf().append(ev)

    def span(self, name: str, args: Optional[dict] = None,
             device=None) -> _Span:
        timer = self._device_timer(device) if device is not None else None
        return _Span(self, name, args, timer, device)

    def anchor(self, device) -> None:
        timer = self._device_timer(device)
        if timer is not None:
            timer.anchor(device)

    def add_arg(self, span: str, key: str, n) -> None:
        """Add ``n`` to arg ``key`` of this thread's innermost open span
        named ``span`` (nothing where none is open)."""
        for sp in reversed(self._open()):
            if sp.name == span:
                if sp.args is None:
                    sp.args = {}
                sp.args[key] = sp.args.get(key, 0) + n
                return

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
        timed = [ev for ev in out if "_marks" in ev]
        if timed:
            timer = timed[0]["_marks"][0]
            at = timer.resolve([m for ev in timed for m in ev["_marks"][1:]])
            for ev, t0, t1 in zip(timed, at[0::2], at[1::2]):
                del ev["_marks"]
                ev["dts"], ev["ddur"] = t0, t1 - t0
        out.sort(key=lambda e: e["ts"])
        return out


# ---------------------------------------------------------------------------
# the process-global tracer (module functions are the instrumentation API)
# ---------------------------------------------------------------------------
_TRACER: Optional[Tracer] = None


def enable(clock: Optional[Callable[[], float]] = None,
           device_clock=None) -> Tracer:
    """Arm tracing (replacing any active tracer), device timing included:
    ``device_clock`` defaults to CUDA events on CUDA devices. Returns the
    new tracer."""
    global _TRACER
    _TRACER = Tracer(clock=clock, device_clock=device_clock)
    return _TRACER


def disable() -> None:
    global _TRACER
    _TRACER = None


def enabled() -> bool:
    return _TRACER is not None


def current() -> Optional[Tracer]:
    return _TRACER


def span(name: str, args: Optional[dict] = None, device=None):
    """A span context manager — :data:`NULL_SPAN` when tracing is off (the
    allocation-free hot path). ``device`` (a ``torch.device``) times it on
    that device's current stream too, where the device clock times it."""
    t = _TRACER
    return t.span(name, args, device) if t is not None else NULL_SPAN


def anchor(device) -> None:
    """Tie ``device``'s clock to the host's here, where the caller has just
    waited for the device (its current stream is idle): one mark and a
    host clock read, no synchronize. A no-op when tracing is off or the
    device clock does not time ``device``."""
    t = _TRACER
    if t is not None:
        t.anchor(device)


def add_arg(span: str, key: str, n) -> None:
    """Add ``n`` to arg ``key`` of this thread's innermost open span named
    ``span``; a no-op when tracing is off."""
    t = _TRACER
    if t is not None:
        t.add_arg(span, key, n)


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
