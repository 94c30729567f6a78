"""Findings, baselines and the JSON report, as ``repro.analysis.report``.

A :class:`Finding` is one violation: a rule or contract ``code`` (``RA1xx``
= AST lint, ``RC2xx`` = census contract), a location (``path:line`` for
lint, ``contract:<entry point>`` for contracts) and a message.

The **baseline** is a checked-in text file
(``src/repro_torch/analysis/baseline.txt``) listing findings that are
*accepted debt*: one fingerprint per line, ``code :: location :: message``,
with ``#`` comments saying why each entry is tolerated. Fingerprints drop
line numbers, so unrelated edits do not invalidate the baseline; everything
else must match exactly. An empty (or absent) baseline means the port is
expected to be clean, and the file ships empty.

``python -m repro_torch.analysis --json`` writes the machine-readable report
to ``artifacts/analysis/torch_report.json`` (schema: :func:`write_report`,
the reference's).
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Iterable, Optional, Sequence

DEFAULT_BASELINE = os.path.join("src", "repro_torch", "analysis",
                                "baseline.txt")
DEFAULT_REPORT_DIR = os.path.join("artifacts", "analysis")
REPORT_NAME = "torch_report.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule or contract violation."""

    code: str       # "RA104", "RC201", ...
    where: str      # "src/repro_torch/serve/x.py" or "contract:train_sync/..."
    message: str
    line: int = 0   # 0 = not line-addressed (contracts)

    @property
    def fingerprint(self) -> str:
        """Line-number-free identity used for baseline matching."""
        return f"{self.code} :: {self.where} :: {self.message}"

    def render(self) -> str:
        loc = f"{self.where}:{self.line}" if self.line else self.where
        return f"{loc}: {self.code} {self.message}"


def load_baseline(path: Optional[str]) -> set[str]:
    """Read accepted-debt fingerprints. Missing file == empty baseline."""
    if path is None or not os.path.exists(path):
        return set()
    out = set()
    with open(path) as f:
        for raw in f:
            line = raw.strip()
            if line and not line.startswith("#"):
                out.add(line)
    return out


def split_by_baseline(findings: Sequence[Finding], baseline: set[str]
                      ) -> tuple[list[Finding], list[Finding]]:
    """(fresh, baselined): fresh findings gate the exit code."""
    fresh, known = [], []
    for f in findings:
        (known if f.fingerprint in baseline else fresh).append(f)
    return fresh, known


def stale_baseline_entries(findings: Sequence[Finding],
                           baseline: set[str]) -> list[str]:
    """Baseline lines no current finding matches: debt that was paid off and
    should be deleted from the file (reported, never fatal)."""
    seen = {f.fingerprint for f in findings}
    return sorted(baseline - seen)


def write_report(path: str, findings: Sequence[Finding],
                 baseline: set[str], skipped: Iterable[str] = (),
                 meta: Optional[dict] = None) -> str:
    """Write the JSON report (atomically). Schema::

        {"meta": {...}, "counts": {"fresh": N, "baselined": M},
         "skipped": ["contract:... (why)", ...],
         "findings": [{"code", "where", "line", "message", "baselined"}...],
         "stale_baseline": ["fingerprint", ...]}
    """
    fresh, known = split_by_baseline(findings, baseline)
    body = {
        "meta": meta or {},
        "counts": {"fresh": len(fresh), "baselined": len(known)},
        "skipped": sorted(skipped),
        "findings": [
            dataclasses.asdict(f) | {"baselined": f.fingerprint in baseline}
            for f in sorted(findings, key=lambda f: (f.code, f.where, f.line))
        ],
        "stale_baseline": stale_baseline_entries(findings, baseline),
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(body, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path
