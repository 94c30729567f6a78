"""What a traced run reads: the profiler's device operations, the program's
``obs`` spans, and the calls into the kernels' wrappers, put on one clock.

The window is profiled with CUDA activity alone (no host operator events,
which would slow the host side of every step). The profiler's clock is tied
to the host's by a marker kernel (``torch.cuda._sleep``) launched right
after a synchronize at a known host time: the one before the window maps
the profiler's time onto ``time.perf_counter``, the one after it shows that
the trace holds the window's end. The profiler is started and stopped once
before the window, so that its device tracing is set up outside it. Where
the trace still comes back without device operations or markers, the run
reports why on standard error, the device trace's readers find nothing,
and the busy time comes from CUDA events around each epoch.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional

import torch

MARKER = "spin_kernel"
MARKER_CYCLES = 20_000
HERE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Calls:
    """The calls the window made into the kernels' wrappers: ``spmm`` as
    (csr, width), ``quantize`` as (rows, width, bits, noise read, scale
    bytes), ``dequantize`` as (rows, width, bits, scale bytes)."""

    spmm: list = dataclasses.field(default_factory=list)
    quantize: list = dataclasses.field(default_factory=list)
    dequantize: list = dataclasses.field(default_factory=list)


class CallRecorder:
    """Wraps the wrappers of the SpMM and the Low-bit Module in the
    program's kernel modules, for the traced window only."""

    def __init__(self):
        self.calls = Calls()
        self._undo = []

    def __enter__(self) -> Calls:
        from repro_torch.kernels.quant import ops as qops
        from repro_torch.kernels.spmm import ops as sops
        calls = self.calls
        launch, quant, dequant = (sops._launch, qops.quantize_pack_rows,
                                  qops.dequantize_rows)

        def _launch(kernel, table, csr, w_args):
            calls.spmm.append((csr, int(table.shape[1])))
            return launch(kernel, table, csr, w_args)

        def quantize_pack_rows(h, u, bits=1, scale_dtype=torch.float32):
            calls.quantize.append((int(h.shape[0]), int(h.shape[1]), bits,
                                   u is not None, scale_dtype.itemsize))
            return quant(h, u, bits, scale_dtype)

        def dequantize_rows(packed, scale, zero, bits, d):
            calls.dequantize.append((int(packed.shape[0]), int(d), bits,
                                     scale.dtype.itemsize))
            return dequant(packed, scale, zero, bits, d)

        for mod, name, fn in ((sops, "_launch", _launch),
                              (qops, "quantize_pack_rows",
                               quantize_pack_rows),
                              (qops, "dequantize_rows", dequantize_rows)):
            self._undo.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)
        return calls

    def __exit__(self, *exc) -> bool:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo.clear()
        return False


def _mark() -> float:
    torch.cuda.synchronize()
    t = time.perf_counter()
    torch.cuda._sleep(MARKER_CYCLES)
    torch.cuda.synchronize()
    return t


def _device_events(prof) -> list:
    """The profiler's device operations as (name, start ns, duration ns),
    from the raw events: building the profiler's event tree would cost
    seconds per ten thousand kernels."""
    from torch.autograd import DeviceType
    return [(e.name(), e.start_ns(), e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


class DeviceTrace:
    """``with DeviceTrace() as dt:`` around the window; afterwards
    ``dt.ops`` holds every device operation as (name, start, end) in host
    seconds (``time.perf_counter``), the markers left out.

    Where the profiler does not start, or its trace holds no device
    operation or no marker to put them on the host's clock, ``ops`` stays
    empty and ``problem`` says why: the readers of the device trace then
    find nothing, and the run's busy time comes from CUDA events."""

    def __init__(self):
        self.ops: list = []
        self.problem: Optional[str] = None
        self._prof = None

    @staticmethod
    def warm_up() -> Optional[str]:
        """Start and stop the profiler once around a marker kernel, so that
        the device tracing is loaded and set up before the window; returns
        what went wrong, if anything."""
        from torch.profiler import ProfilerActivity, profile
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                _mark()
            if not any(MARKER in n for n, _, _ in _device_events(prof)):
                return "the warm-up trace holds no marker kernel"
        except Exception as e:  # the run goes on without the device trace
            return f"the profiler failed in the warm-up: {e!r}"
        return None

    def __enter__(self) -> "DeviceTrace":
        from torch.profiler import ProfilerActivity, profile
        try:
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.__enter__()
        except Exception as e:  # the run goes on without the device trace
            self.problem = f"the profiler did not start: {e!r}"
            return self
        self._prof = prof
        self._h0 = _mark()
        return self

    def __exit__(self, *exc) -> bool:
        if self._prof is None:
            return False
        h1 = _mark()
        prof, self._prof = self._prof, None
        try:
            prof.__exit__(*exc)
            evs = _device_events(prof)
        except Exception as e:  # the run goes on without the device trace
            self.problem = f"the profiler failed to stop: {e!r}"
            return False
        self.ops, self.problem = place(evs, self._h0, h1)
        return False


def place(evs: list, h0: float, h1: float) -> tuple:
    """The profiler's device events (name, start ns, duration ns) on the
    host's clock: ``(ops, problem)``, ops as (name, start, end) in host
    seconds with the markers left out, or ``([], why)``. ``h0`` and ``h1``
    are the host times at which the markers before and after the window
    were launched onto an idle card."""
    marks = sorted(s for n, s, _ in evs if MARKER in n)
    others = [s for n, s, _ in evs if MARKER not in n]
    if not others:
        return [], "the device trace holds no device operation"
    if not marks:
        return [], ("the device trace holds no marker kernel to put it on "
                    "the host's clock")
    # profiler nanoseconds -> host seconds: from the marker launched before
    # the window, or, where the trace lost that one, from the one after it
    if marks[0] <= min(others):
        m0, h = marks[0], h0
    else:
        m0, h = marks[-1], h1
    return [(n, (s - m0) * 1e-9 + h, (s + d - m0) * 1e-9 + h)
            for n, s, d in evs if MARKER not in n], None


class EpochEvents:
    """CUDA events recorded around each epoch of the window: the busy time
    where the profiler's trace is missing. Each epoch starts on an idle
    card (the one before ended in its loss's sync), so the time between
    its two events is its device work and the host's gaps inside it."""

    def __init__(self):
        self.pairs: list = []

    def start(self):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, start) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.pairs.append((start, ev))

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs) * 1e-3


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    total, end = 0.0, lo
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def idle_gaps(intervals, lo: float, hi: float) -> list:
    """The gaps of ``[lo, hi]`` in which no interval runs, as (start, end)."""
    gaps, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            gaps.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    return [(s, e) for s, e in gaps if e > s]


def kernel_names(layer: str) -> list:
    """Substrings of the names of a layer's kernels:
    ``bench/metrics/kernels/<layer>.json``."""
    with open(HERE.parent / "metrics" / "kernels" / f"{layer}.json") as f:
        return json.load(f)


def peaks(kind: str) -> Optional[dict]:
    with open(HERE / "peaks.json") as f:
        return json.load(f).get(kind)


@dataclasses.dataclass
class TracedRun:
    """Everything a per-layer reader may read of one traced window."""

    ops: list                  # (name, start, end) host seconds
    spans: list                # the program's obs events in the window
    t0: float                  # window start, host seconds
    t1: float                  # window end
    n_epochs: int
    wire_bytes: list           # per epoch: the trainer's wire bytes
    calls: Calls
    flops_per_epoch: float
    peaks: Optional[dict]      # the card's published peaks, or None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def kernels_of(self, layer: str) -> list:
        keys = [k.lower() for k in kernel_names(layer)]
        return [op for op in self.launches()
                if any(k in op[0].lower() for k in keys)]

    def device_seconds(self, layer: str) -> float:
        return sum(e - s for _, s, e in self.kernels_of(layer))

    def launches(self) -> list:
        return [op for op in self.ops
                if not op[0].startswith(("Memcpy", "Memset"))]


def span_path(spans: list, t: float) -> str:
    """The program's spans open at host time ``t``, outermost first."""
    open_ = [ev for ev in spans if ev.get("ph") == "X"
             and ev["ts"] <= t < ev["ts"] + ev["dur"]]
    open_.sort(key=lambda ev: (ev["ts"], -ev["dur"]))
    names = []
    for ev in open_:
        mode = (ev.get("args") or {}).get("mode")
        names.append(f"{ev['name']}({mode})" if mode else ev["name"])
    return ">".join(names) or "outside any span"


def breakdown(run: TracedRun, top: int = 10) -> dict:
    """The device operations that took most time in the window, and its
    longest idle gaps named by the spans open on the host."""
    by_name: dict = {}
    for name, s, e in run.ops:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = idle_gaps([(s, e) for _, s, e in run.ops], run.t0, run.t1)
    gaps.sort(key=lambda g: -(g[1] - g[0]))
    return {"device_ops": [[n[:160], v] for n, v in ops],
            "idle_gaps": [[span_path(run.spans, s), e - s]
                          for s, e in gaps[:top]]}
