"""Exporters: Chrome/Perfetto trace JSON, flat metrics JSON, renderers.

A copy of ``repro.obs.export``; the two packages write and read the same
files (schema ``repro.obs/1``). The port's artifacts default to
``artifacts/torch/obs/`` (untracked), one pair per traced run:

* ``<name>.trace.json`` — Chrome ``trace_event`` format (open in Perfetto or
  ``chrome://tracing``): ``{"traceEvents": [{"name", "ph", "ts", "dur",
  "pid", "tid", "args"}], "displayTimeUnit": "ms"}``, timestamps in µs.
  A span timed on the device (``dts`` / ``ddur``) is followed by its device
  interval, ``<name>:device`` on a track of its own (``DEVICE_TID``, named
  ``device``), so the timeline shows host and device side by side.
* ``<name>.metrics.json`` — the metrics-registry snapshot plus an optional
  modeled-vs-measured join (each epoch's measured wall time against a
  modeled exposed / overlapped communication time, ``drift_s`` the gap).

The CLI (``python -m repro_torch.obs``) renders these: ``summarize``
tabulates every metrics file in a directory, ``timeline`` draws a trace as
an ASCII gantt, ``diff`` compares two metrics snapshots counter by counter.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

SCHEMA = "repro.obs/1"
# the trace's device track: a thread id no host thread has
DEVICE_TID = 1


def default_obs_dir() -> Path:
    """``<repo>/artifacts/torch/obs``: the port's own, beside the JAX
    package's ``artifacts/obs``."""
    return Path(__file__).resolve().parents[3] / "artifacts" / "torch" / "obs"


# ---------------------------------------------------------------------------
# writers
# ---------------------------------------------------------------------------
def _us(seconds: float) -> int:
    return int(round(seconds * 1e6))


def to_trace_events(events: Sequence[dict], pid: int = 0) -> list[dict]:
    """Tracer events (seconds) -> Chrome ``trace_event`` dicts (µs ints);
    device intervals on the ``DEVICE_TID`` track."""
    out, named = [], False
    for ev in events:
        te = {"name": ev["name"], "ph": ev["ph"], "ts": _us(ev["ts"]),
              "pid": pid, "tid": ev.get("tid", 0)}
        if ev["ph"] == "X":
            te["dur"] = max(_us(ev["dur"]), 0)
        if ev.get("args"):
            te["args"] = ev["args"]
        out.append(te)
        if "dts" in ev:
            if not named:
                out.insert(0, {"name": "thread_name", "ph": "M", "pid": pid,
                               "tid": DEVICE_TID, "args": {"name": "device"}})
                named = True
            dev = {"name": f"{ev['name']}:device", "ph": "X",
                   "ts": _us(ev["dts"]), "dur": max(_us(ev["ddur"]), 0),
                   "pid": pid, "tid": DEVICE_TID}
            if ev.get("args"):
                dev["args"] = ev["args"]
            out.append(dev)
    return out


def write_trace(path, events: Sequence[dict], pid: int = 0) -> Path:
    """Write a Perfetto-loadable trace file; returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    body = {"traceEvents": to_trace_events(events, pid=pid),
            "displayTimeUnit": "ms"}
    path.write_text(json.dumps(body, indent=1, default=float))
    return path


def modeled_vs_measured(epoch_wall_s: Sequence[float], exposed_s: float,
                        overlapped_s: float) -> dict:
    """Join measured per-epoch wall time against a modeled comm split.

    The modeled numbers are per-epoch constants; the measured walls vary.
    ``drift_s`` = mean measured wall − modeled exposed comm: how far the
    comm model sits from the measured run."""
    walls = [float(w) for w in epoch_wall_s]
    mean_wall = sum(walls) / len(walls) if walls else 0.0
    return {
        "epochs": [{"epoch": i, "wall_s": w,
                    "modeled_exposed_s": float(exposed_s),
                    "modeled_overlapped_s": float(overlapped_s),
                    "drift_s": w - float(exposed_s)}
                   for i, w in enumerate(walls)],
        "n_epochs": len(walls),
        "mean_wall_s": mean_wall,
        "modeled_exposed_s": float(exposed_s),
        "modeled_overlapped_s": float(overlapped_s),
        "drift_s": mean_wall - float(exposed_s),
    }


def write_metrics(path, *, metrics: dict, run: Optional[str] = None,
                  merge: Optional[dict] = None,
                  trace_path: Optional[str] = None) -> Path:
    """Write the flat metrics JSON (registry snapshot + optional
    modeled-vs-measured join); returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    body = {"schema": SCHEMA, "run": run, "metrics": metrics,
            "modeled_vs_measured": merge, "trace_path": trace_path}
    path.write_text(json.dumps(body, indent=1, default=float))
    return path


# ---------------------------------------------------------------------------
# readers / renderers (the CLI's meat — pure functions returning strings)
# ---------------------------------------------------------------------------
def load_metrics(path) -> dict:
    body = json.loads(Path(path).read_text())
    if body.get("schema") != SCHEMA:
        raise ValueError(f"{path}: not a {SCHEMA} metrics file "
                         f"(schema={body.get('schema')!r})")
    return body


def metrics_files(directory) -> list[Path]:
    return sorted(Path(directory).glob("*.metrics.json"))


def render_summary(directory) -> str:
    """One line per metrics file: measured epoch wall joined against the
    modeled exposed/overlapped split, plus the headline counters."""
    files = metrics_files(directory)
    if not files:
        raise FileNotFoundError(
            f"no *.metrics.json under {directory} — write one first "
            "with repro_torch.obs.write_metrics")
    lines = [f"obs summary: {directory} ({len(files)} run(s))",
             f"{'run':58s} {'epochs':>6s} {'wall/ep':>10s} "
             f"{'exposed':>10s} {'overlap':>10s} {'drift':>10s} "
             f"{'retrace':>7s}"]
    for f in files:
        body = load_metrics(f)
        run = body.get("run") or f.name[:-len(".metrics.json")]
        mm = body.get("modeled_vs_measured") or {}
        counters = body.get("metrics", {}).get("counters", {})
        retraces = sum(v for k, v in counters.items()
                       if k.startswith("retrace."))
        lines.append(
            f"{run:58s} {mm.get('n_epochs', 0):6d} "
            f"{mm.get('mean_wall_s', 0.0):9.4f}s "
            f"{mm.get('modeled_exposed_s', 0.0):9.6f}s "
            f"{mm.get('modeled_overlapped_s', 0.0):9.6f}s "
            f"{mm.get('drift_s', 0.0):9.4f}s {retraces:7d}")
    return "\n".join(lines)


def load_trace(path) -> list[dict]:
    body = json.loads(Path(path).read_text())
    events = body.get("traceEvents")
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents array — not a "
                         "trace_event JSON")
    return events


def render_timeline(path, width: int = 64,
                    limit: Optional[int] = None) -> str:
    """ASCII gantt of a trace file: one row per event, bar position/length
    proportional to ts/dur over the trace's span. Instant events render as a
    single tick. ``limit`` caps the rows (traces can hold thousands)."""
    events = [e for e in load_trace(path) if e["ph"] in ("X", "i")]
    if not events:
        return f"{path}: empty trace"
    t0 = min(e["ts"] for e in events)
    t1 = max(e["ts"] + e.get("dur", 0) for e in events)
    span = max(t1 - t0, 1)
    shown = events if limit is None else events[:limit]
    lines = [f"timeline: {path} ({len(events)} events, "
             f"{span / 1e3:.3f} ms)"]
    for e in shown:
        off = int((e["ts"] - t0) / span * width)
        if e["ph"] == "i":
            bar = " " * off + "|"
        else:
            n = max(int(e.get("dur", 0) / span * width), 1)
            bar = " " * off + "#" * min(n, width - off or 1)
        dur_ms = e.get("dur", 0) / 1e3
        lines.append(f"{e['name']:24.24s} [{bar:<{width}s}] {dur_ms:9.3f} ms")
    if limit is not None and len(events) > limit:
        lines.append(f"... {len(events) - limit} more (raise --limit)")
    return "\n".join(lines)


def render_diff(path_a, path_b) -> str:
    """Counter-by-counter delta between two metrics snapshots (b − a)."""
    a, b = load_metrics(path_a), load_metrics(path_b)
    ca = a.get("metrics", {}).get("counters", {})
    cb = b.get("metrics", {}).get("counters", {})
    names = sorted(set(ca) | set(cb))
    lines = [f"diff: {path_a} -> {path_b}",
             f"{'counter':40s} {'a':>12s} {'b':>12s} {'delta':>12s}"]
    for n in names:
        va, vb = ca.get(n, 0), cb.get(n, 0)
        lines.append(f"{n:40s} {va:12g} {vb:12g} {vb - va:+12g}")
    ma = (a.get("modeled_vs_measured") or {})
    mb = (b.get("modeled_vs_measured") or {})
    if ma or mb:
        da, db = ma.get("drift_s", 0.0), mb.get("drift_s", 0.0)
        lines.append(f"{'drift_s':40s} {da:12.4f} {db:12.4f} "
                     f"{db - da:+12.4f}")
    return "\n".join(lines)
