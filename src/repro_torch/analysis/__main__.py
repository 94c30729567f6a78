"""``python -m repro_torch.analysis`` — the exit-code-gated static checks.

Runs the AST lint and (unless ``--lint-only``) the census contracts,
subtracts the checked-in baseline, prints fresh findings and exits 1 if any
remain. ``--json`` also writes ``artifacts/analysis/torch_report.json``.
``--device`` is where the contracts run: ``cuda`` (the default; it raises
without a card) or ``cpu`` (the kernels' plain versions). The sharded
contracts run in four ``gloo`` processes on that device.

    PYTHONPATH=src python -m repro_torch.analysis --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="census contracts + lint of the PyTorch port")
    ap.add_argument("paths", nargs="*", help="files/dirs to lint "
                    "(default: src/repro_torch under --root)")
    ap.add_argument("--root", default=".", help="repo root (default: cwd)")
    ap.add_argument("--baseline", default=None,
                    help="accepted-debt file (default: "
                    "src/repro_torch/analysis/baseline.txt under --root)")
    ap.add_argument("--lint-only", action="store_true",
                    help="skip the census contracts (no device needed)")
    ap.add_argument("--contracts-only", action="store_true",
                    help="skip the AST lint")
    ap.add_argument("--json", action="store_true",
                    help="write artifacts/analysis/torch_report.json")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-finding output (exit code only)")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda",
                    help="where the contracts run (default: cuda)")
    args = ap.parse_args(argv)

    from .report import (DEFAULT_BASELINE, DEFAULT_REPORT_DIR, REPORT_NAME,
                         load_baseline, split_by_baseline,
                         stale_baseline_entries, write_report)

    findings, skipped, lanes = [], [], []
    if not args.contracts_only:
        from .lint import DEFAULT_PATHS, run_lint
        paths = args.paths or [os.path.join(args.root, p)
                               for p in DEFAULT_PATHS]
        findings.extend(run_lint(paths, root=args.root))
        lanes.append("lint")
    if not args.lint_only:
        from ..dist.runtime import resolve_device
        from .contracts import run_contracts
        cfind, cskip = run_contracts(device=resolve_device(args.device))
        findings.extend(cfind)
        skipped.extend(cskip)
        lanes.append("contracts")

    baseline_path = args.baseline or os.path.join(args.root, DEFAULT_BASELINE)
    baseline = load_baseline(baseline_path)
    fresh, known = split_by_baseline(findings, baseline)
    stale = stale_baseline_entries(findings, baseline)

    if args.json:
        out = write_report(
            os.path.join(args.root, DEFAULT_REPORT_DIR, REPORT_NAME),
            findings, baseline, skipped,
            meta={"lanes": lanes, "device": args.device})
        if not args.quiet:
            print(f"report: {out}")

    if not args.quiet:
        for f in sorted(fresh, key=lambda f: (f.code, f.where, f.line)):
            print(f.render())
        for note in skipped:
            print(f"skipped: {note}")
        for fp in stale:
            print(f"stale baseline entry (fixed? delete it): {fp}")
        print(f"analysis[{'+'.join(lanes)}]: {len(fresh)} finding(s), "
              f"{len(known)} baselined, {len(skipped)} skipped")
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
