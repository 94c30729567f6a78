#!/usr/bin/env python3
"""Where a benchmark cell's epoch goes, by the program's own spans: one
traced run of the cell, its window put in a table.

    python3 tools/torch_span_table.py --workload graphsage-reddit-sylvie_a \\
        --seed N [--seconds 10] [--out FILE]

Runs ``bench/run.py``'s ``run`` with tracing on, in this process, on the
CUDA card, and keeps the window's spans and the profiler's device
operations (handed to the metric readers). Prints, per step mode (sync,
async) and per span key (``halo`` by site, direction and kind; ``agg`` by
direction and width):

* the span's device ms per step of that mode (``ddur``), its count per
  step and its bytes per step;
* the profiler's kernels inside its device interval, by layer (SpMM,
  Low-bit, the rest), in device ms per step;

and per mode the step's host ms and its dispatch (the step less its
``wait``); then the set-up gauges against ``setup_marks``' ``graph`` to
``program`` interval, the run's metrics, the process's ``halo.*``
counters (``halo.gslot_wired`` / ``halo.gslot_skipped``: the async steps'
gradient slots, warm-up included), and how the SpMM and Low-bit
kernels of the profiler's trace lie in the spans that should hold them
(:func:`containment`: the two clocks' agreement). The profiler's trace is
put on the host clock once per window, the spans at every step, so the
kernels are placed under one offset per step. One JSON object of all of it
goes to ``FILE`` when given; ``--raw`` also keeps the window's spans and
operations.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from bench import run as R  # noqa: E402

SETUP = ("setup.normalize_s", "setup.partition_s", "setup.trainer_s")


def _key(ev: dict) -> str:
    a = ev.get("args") or {}
    if ev["name"] == "halo":
        return f"halo site {a['site']} {a['dir']} {a['kind']}"
    return f"agg {a['dir']} width {a['width']}"


def _layer(name: str) -> str:
    if "spmm_" in name.lower():
        return "spmm"
    if "quantize_pack" in name or "unpack_dequantize" in name:
        return "lowbit"
    return "other"


def table(ops: list, spans: list, reach: float = 2e-3) -> dict:
    """Per step mode: span keys with their device ms, count, bytes and the
    kernels inside them, per step of that mode."""
    steps = sorted((ev for ev in spans if ev["name"] == "step"),
                   key=lambda ev: ev["ts"])
    starts = [st["ts"] for st in steps]
    n_mode: dict = defaultdict(int)
    for st in steps:
        n_mode[st["args"]["mode"]] += 1

    def mode_of(ev):
        i = bisect.bisect_right(starts, ev["ts"]) - 1
        if i < 0 or ev["ts"] > starts[i] + steps[i]["dur"]:
            return None
        return steps[i]["args"]["mode"]

    timed = sorted((ev for ev in spans if ev["name"] in ("halo", "agg")
                    and "dts" in ev), key=lambda ev: ev["dts"])
    rows: dict = defaultdict(lambda: defaultdict(float))
    for ev in timed:
        m = mode_of(ev)
        if m is None:
            continue
        row = rows[(m, _key(ev))]
        row["device_ms"] += ev["ddur"] * 1e3
        row["count"] += 1
        row["bytes"] += (ev.get("args") or {}).get("bytes", 0)
    # each kernel, under its step's offset, to the span it overlaps most,
    # where its midpoint lies inside that span
    shift = _shifts(ops, timed, starts, reach)
    for name, s, e, ev, _ in _matches(ops, timed, shift, starts, reach,
                                      every=True):
        inside = ev is not None and \
            ev["dts"] <= (s + e) / 2 <= ev["dts"] + ev["ddur"]
        m = mode_of(ev) if inside else None
        if m is not None:
            rows[(m, _key(ev))][_layer(name) + "_ms"] += (e - s) * 1e3
    out: dict = {}
    for (m, key), row in sorted(rows.items()):
        out.setdefault(m, {"steps": n_mode[m], "spans": {}})
        out[m]["spans"][key] = {k: v / n_mode[m] for k, v in row.items()}
    for m in out:
        mine = [st for st in steps if st["args"]["mode"] == m]
        waits = [ev for ev in spans if ev["name"] == "wait"]
        host = [st["dur"] for st in mine]
        disp = [st["dur"] - sum(w["dur"] for w in waits
                                if st["ts"] <= w["ts"] < st["ts"] + st["dur"])
                for st in mine]
        out[m]["step_host_ms"] = sum(host) / len(host) * 1e3
        out[m]["dispatch_ms"] = sum(disp) / len(disp) * 1e3
    return out


def _matches(ops: list, timed: list, shift: dict, starts: list,
             reach: float, every: bool = False) -> list:
    """Each SpMM or Low-bit kernel (``every``: each kernel) with the span it
    overlaps most within ``reach`` once moved by ``-shift[step]`` (``halo``
    for Low-bit, ``agg`` or ``halo`` for the rest): (name, start, end,
    span, step), the kernel moved."""
    dstarts = [ev["dts"] for ev in timed]
    out = []
    for name, s, e in ops:
        layer = _layer(name)
        if layer == "other" and not every:
            continue
        allowed = ("halo",) if layer == "lowbit" else ("halo", "agg")
        step, d = None, 0.0
        for _ in range(2):       # match; again under the step's offset
            i = bisect.bisect_right(dstarts, e - d + reach)
            best = max((ev for ev in timed[max(i - 64, 0):i]
                        if ev["name"] in allowed
                        and ev["dts"] + ev["ddur"] >= s - d - reach),
                       key=lambda ev: min(e - d, ev["dts"] + ev["ddur"])
                       - max(s - d, ev["dts"]), default=None)
            if best is None:
                break
            step = bisect.bisect_right(starts, best["ts"]) - 1
            if shift.get(step, 0.0) == d:
                break
            d = shift[step]
        out.append((name, s - d, e - d, best, step))
    return out


def _shifts(ops: list, timed: list, starts: list, reach: float) -> dict:
    """Each step's offset of the profiler's trace from the spans: the least
    start gap between an ``agg`` span and the SpMM kernel it overlaps most
    (an aggregation's first kernel starts with it)."""
    shift: dict = {}
    for _, s, _, span, step in _matches(ops, timed, {}, starts, reach):
        if span is not None and span["name"] == "agg":
            shift[step] = min(shift.get(step, float("inf")), s - span["dts"])
    return shift


def containment(ops: list, spans: list, slack: float = 20e-6,
                reach: float = 2e-3) -> dict:
    """How the profiler's SpMM and Low-bit kernels sit in the spans' device
    intervals (the profiler's trace is placed once per window, the spans
    at every step). Each step's offset between the two is the least start
    gap between an ``agg`` span and the kernel it overlaps most (an
    aggregation's first kernel starts with it); each kernel, moved by its
    step's offset, is matched to the span it overlaps most, and lies
    ``g`` after its start and ``h`` before its end. Reports the kernels
    outside their span by more than ``slack`` at either end, the largest
    such distance, and the range of the steps' offsets; and, with no
    profiler, the most by which a span's device interval starts before its
    host start (``early_max_us``): a mark is recorded after its host
    start, so a device clock anchored right reads it no earlier, up to the
    anchor's own launch latency."""
    steps = sorted((ev for ev in spans if ev["name"] == "step"),
                   key=lambda ev: ev["ts"])
    starts = [st["ts"] for st in steps]
    timed = sorted((ev for ev in spans if ev["name"] in ("halo", "agg")
                    and "dts" in ev), key=lambda ev: ev["dts"])
    shift = _shifts(ops, timed, starts, reach)
    worst, outside, unmatched, n = 0.0, 0, 0, 0
    for _, s, e, span, step in _matches(ops, timed, shift, starts, reach):
        n += 1
        if span is None or step is None or step < 0:
            unmatched += 1
            continue
        far = max(span["dts"] - s, e - span["dts"] - span["ddur"])
        worst = max(worst, far)
        outside += far > slack
    offsets = sorted(shift.values())
    return {"kernels": n, "unmatched": unmatched, "outside": outside,
            "outside_max_us": worst * 1e6, "steps": len(shift),
            "early_max_us": max((ev["ts"] - ev["dts"] for ev in timed),
                                default=0.0) * 1e6,
            "step_offset_us": [offsets[0] * 1e6 if offsets else 0.0,
                               offsets[-1] * 1e6 if offsets else 0.0]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--raw", default=None,
                    help="also write the window's ops and spans (gzip JSON)")
    args = ap.parse_args(argv)
    seen = []
    load = R.load_reader

    def load_reader(root, metric):
        read = load(root, metric)

        def keep(run):
            if not seen:
                seen.append((list(run.ops), list(run.spans)))
            return read(run)
        return keep

    R.load_reader = load_reader
    from repro_torch import obs
    res = R.run(R.load_cell(ROOT, args.workload), args.seed, args.seconds,
                True, "cuda", ROOT)
    ops, spans = seen[0] if seen else ([], [])
    marks = dict(res["setup_marks"])
    gauges = {k: obs.snapshot()["gauges"].get(k) for k in SETUP}
    program = marks["program"] - marks["graph"]
    counters = {k: v for k, v in obs.snapshot()["counters"].items()
                if k.startswith("halo.")}
    out = {"workload": args.workload, "seed": args.seed,
           "correct": res["correct"], "trace_notes": res["trace_notes"],
           "metrics": {k: v["value"] for k, v in res["metrics"].items()},
           "counters": counters,
           "setup_marks": res["setup_marks"], "setup_gauges": gauges,
           "setup_covered": sum(v or 0.0 for v in gauges.values()) / program,
           "table": table(ops, spans),
           "containment": containment(ops, spans)}
    print(f"{args.workload} seed {args.seed}: correct {res['correct']}, "
          f"notes {res['trace_notes']}")
    for m, body in out["table"].items():
        print(f"[{m}] {body['steps']} steps; step host "
              f"{body['step_host_ms']:.3f} ms, dispatch "
              f"{body['dispatch_ms']:.3f} ms; per step:")
        for key, row in body["spans"].items():
            print(f"  {key:34s} " + " ".join(
                f"{k} {v:.3f}" for k, v in sorted(row.items())))
    print("set-up: graph -> program "
          f"{program:.2f} s; " + ", ".join(
              f"{k} {v:.2f}" for k, v in gauges.items() if v is not None)
          + f"; covered {out['setup_covered']:.3f}")
    print("metrics: " + json.dumps(out["metrics"]))
    print("counters: " + json.dumps(counters))
    print("containment: " + json.dumps(out["containment"]))
    if args.raw:
        import gzip
        with gzip.open(args.raw, "wt") as f:
            json.dump({"ops": ops, "spans": spans}, f)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(json.dumps(out) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
