"""CLI: render observability artifacts.

    python -m repro_torch.obs summarize [DIR]     # default artifacts/torch/obs
    python -m repro_torch.obs timeline TRACE.json [--width N] [--limit N]
    python -m repro_torch.obs diff A.metrics.json B.metrics.json

It reads the files of either package (the same formats). Exit codes: 0 on
success, 2 on missing or invalid artifacts.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from . import export


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m repro_torch.obs",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("summarize",
                        help="tabulate every *.metrics.json in a directory")
    ps.add_argument("dir", nargs="?", default=None,
                    help="directory of metrics files "
                         "(default: artifacts/torch/obs, searched recursively)")

    pt = sub.add_parser("timeline",
                        help="render a trace file as an ASCII gantt")
    pt.add_argument("trace", help="a *.trace.json file")
    pt.add_argument("--width", type=int, default=64)
    pt.add_argument("--limit", type=int, default=80,
                    help="max rows (0 = unlimited)")

    pd = sub.add_parser("diff",
                        help="counter-by-counter delta of two metrics files")
    pd.add_argument("a")
    pd.add_argument("b")

    args = p.parse_args(argv)
    try:
        if args.cmd == "summarize":
            if args.dir is not None:
                print(export.render_summary(args.dir))
            else:
                # default: every run directory under artifacts/torch/obs
                root = export.default_obs_dir()
                dirs = sorted({f.parent
                               for f in root.rglob("*.metrics.json")})
                if not dirs:
                    raise FileNotFoundError(
                        f"no *.metrics.json under {root} — write one "
                        "first with repro_torch.obs.write_metrics")
                print("\n\n".join(export.render_summary(d) for d in dirs))
        elif args.cmd == "timeline":
            limit = None if args.limit == 0 else args.limit
            print(export.render_timeline(Path(args.trace),
                                         width=args.width, limit=limit))
        elif args.cmd == "diff":
            print(export.render_diff(Path(args.a), Path(args.b)))
    except (FileNotFoundError, ValueError, OSError) as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
