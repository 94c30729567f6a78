#!/usr/bin/env python3
"""Split the wall time of a ``chip_smoke.py`` run by phase, from the times
its lines appear: run a command unbuffered, stamp each line of its output,
and charge the time since the line before to the phase named by the line's
``[tag]`` (a ``[profile]`` line, or a line without a tag, to the phase in
progress). Works on any checkout's ``chip_smoke.py``, so two commits can be
compared phase by phase in one call.

    python3 tools/torch_phase_times.py --out times.json -- python3 chip_smoke.py

Prints the command's output as it comes, then one JSON line: the command's
exit code, its total seconds and the seconds of each phase in order; with
``--out`` the JSON (and every stamped line) also goes to that file.
"""
import argparse
import json
import os
import re
import subprocess
import sys
import time

TAG = re.compile(r"^\[([a-z][a-z0-9-]*)\]")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    cmd = args.cmd[1:] if args.cmd[:1] == ["--"] else args.cmd
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = last = time.perf_counter()
    phases: dict = {}
    stamped = []
    phase = "start"
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    for line in proc.stdout:
        now = time.perf_counter()
        m = TAG.match(line)
        if m and m.group(1) != "profile":
            phase = m.group(1)
        phases[phase] = phases.get(phase, 0.0) + (now - last)
        last = now
        stamped.append(f"{now - t0:9.3f} {line.rstrip()}")
        sys.stdout.write(line)
    rc = proc.wait()
    now = time.perf_counter()
    phases["end"] = now - last
    res = dict(rc=rc, seconds=now - t0,
               phases={k: round(v, 3) for k, v in phases.items()})
    print(json.dumps(res), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(res, lines=stamped), f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
