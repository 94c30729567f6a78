"""Runs of one cell in sets, and the spread that its bounds are set from.

    python3 bench/tools/sets.py --workload graphsage-reddit-vanilla \\
        --seeds 11 12 13 14 15 16 --sets 2 --seconds 10 --traced 21 22 23

The port's kernels are built first, in a process of their own, so that
every run reads a warm build cache (as each of the driver's runs but the
first does); the seconds of that build are printed. Each set then runs the
cell once per seed, one process at a time, with ``--trace 0``; the traced
seeds then run once each with ``--trace 1``.
Every result line goes to ``chiprun_out/sets_<cell>.jsonl``. The summary
gives, for each end-to-end metric and set, the median and the spread: the
distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) over the median, with and without
the run farthest from the median.
"""
from __future__ import annotations

import argparse
import json
import resource
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one_run(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
           workload, "--seed", str(seed), "--seconds", str(seconds),
           "--trace", str(trace)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    row = {"seed": seed, "trace": trace, "rc": proc.returncode,
           "wall_s": wall, "stderr_tail": proc.stderr[-600:],
           # the largest resident set of any run so far, in GB
           "host_rss_gb": resource.getrusage(
               resource.RUSAGE_CHILDREN).ru_maxrss / 1e6}
    if proc.returncode == 0 and lines:
        row["result"] = json.loads(lines[-1])
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--traced", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    out = ROOT / "chiprun_out" / f"sets_{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    build = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, 'src'); "
         "from repro_torch.kernels import build; print(build.build_all())"],
        capture_output=True, text=True, cwd=ROOT, check=True)
    print(json.dumps({"build_s": float(build.stdout.split()[-1])}))
    sets = []
    for i in range(args.sets):
        rows = []
        for seed in args.seeds:
            row = one_run(args.workload, seed, args.seconds, 0)
            row["set"] = i
            rows.append(row)
            with open(out, "a") as f:
                f.write(json.dumps(row) + "\n")
        sets.append(rows)
    for seed in args.traced:
        row = one_run(args.workload, seed, args.seconds, 1)
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        res = row.get("result", {})
        print(json.dumps({"traced_seed": seed, "rc": row["rc"],
                          "wall_s": row["wall_s"],
                          "correct": res.get("correct"),
                          "metrics": {k: v["value"] for k, v in
                                      res.get("metrics", {}).items()},
                          "device": res.get("device"),
                          "checks": res.get("checks")}))
    summary = {}
    for i, rows in enumerate(sets):
        ok = [r["result"] for r in rows if "result" in r]
        summary[f"set{i}"] = {
            "runs": len(rows), "ok": len(ok),
            "correct": sum(bool(r["correct"]) for r in ok),
            "wall_s": [round(r["wall_s"], 1) for r in rows],
            "checks_max": {k: max(r["checks"][k]["value"] for r in ok)
                           for k in (ok[0]["checks"] if ok else {})}}
        for name in (ok[0]["metrics"] if ok else {}):
            vals = [r["metrics"][name]["value"] for r in ok]
            med = statistics.median(vals)
            far = max(range(len(vals)), key=lambda j: abs(vals[j] - med))
            trimmed = vals[:far] + vals[far + 1:]
            summary[f"set{i}"][name] = {
                "median": med, "spread": spread(vals),
                "spread_trimmed": spread(trimmed), "values": vals}
    print(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
