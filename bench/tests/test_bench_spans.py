"""The program's spans and the profiler's trace on one clock, on the card:
one traced run of each cell at its full configuration, in a process of its
own (``tools/torch_span_table.py``), in which

* every SpMM kernel the profiler saw lies inside the device interval of an
  ``agg`` or ``halo`` span and every Low-bit kernel inside a ``halo``
  span, within ``SLACK`` at each end, once the profiler's trace is moved by
  one offset per step: the spans are anchored to the host clock at every
  step, the profiler's trace once per window (its marker kernels). Each
  step's offset is fitted on that step's kernels (its least gap between an
  ``agg`` span's start and its first kernel's), so it is bounded: under
  ``STRAY``, over the 80 to 320 µs that the offsets were read at on the
  card (``containment`` in the tool);
* with no profiler, no span's device interval starts before its host start
  by more than ``SLACK``: its start mark is recorded after the host read
  its start, so this holds wherever the anchor of its step holds;
* every metric the cell lists reads a value, with no trace note;
* ``exchange.moved_mb`` is the plan's reckoning for the exchanges each step
  ran, within 1%: every exchange of ``exchange.wire_mb`` but, in a sync
  step, site 0's backward (its input needs no gradient), which ships what
  site 0's forward ships."""
from __future__ import annotations

import gzip
import json
import subprocess
import sys

import pytest

from bench import run as R
from bench.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 3407
SLACK = 20e-6
STRAY = 500e-6


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_kernels_lie_inside_their_spans(card, name, tmp_path):
    out, raw = tmp_path / "table.jsonl", tmp_path / "raw.json.gz"
    r = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_span_table.py"),
         "--workload", name, "--seed", str(SEED), "--seconds", "4",
         "--out", str(out), "--raw", str(raw)],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(out.read_text())
    assert res["correct"] and res["trace_notes"] == []
    listed = [m["name"] for m in R.cell_metrics(ROOT, name)]
    assert sorted(res["metrics"]) == sorted(listed)

    c = res["containment"]
    print(name, json.dumps(c))
    assert c["kernels"] > 0 and c["steps"] > 0 and c["unmatched"] == 0, c
    assert c["outside"] == 0 and c["outside_max_us"] <= SLACK * 1e6, c
    assert max(abs(o) for o in c["step_offset_us"]) < STRAY * 1e6, c
    assert c["early_max_us"] <= SLACK * 1e6, c

    spans = json.load(gzip.open(raw, "rt"))["spans"]
    modes = [ev["args"]["mode"] for ev in spans if ev["name"] == "step"]
    site0 = next(ev["args"]["bytes"] for ev in spans if ev["name"] == "halo"
                 and ev["args"]["site"] == 0 and ev["args"]["dir"] == "fwd")
    wire = res["metrics"]["exchange.wire_mb"] * 1e6
    want = sum(wire - (site0 if m == "sync" else 0) for m in modes)
    got = res["metrics"]["exchange.moved_mb"] * 1e6 * len(modes)
    assert got == pytest.approx(want, rel=0.01)
