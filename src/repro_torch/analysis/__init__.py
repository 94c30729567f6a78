"""repro_torch.analysis — the port's static checks, as ``repro.analysis``.

Two layers, one gate:

* **AST lint** (``repro_torch.analysis.lint``): the reference's rules whose
  meaning survives an eager program — device work at import time (RA104),
  unused imports (RA107), raw wall-clock reads in instrumented modules
  (RA108) — on stdlib ``ast``;
* **census contracts** (``repro_torch.analysis.contracts``): run the real
  train / eval / serve entry points once under a census
  (``analysis.census``: halo-backend calls, ``torch.distributed``
  collectives, kernel launches) and hold it to the reference's contracts
  (RC2xx) — collectives per ring bucket, wire dtypes, backward ring
  inversion, step-cache budgets, and census equality under faults, the
  overlap schedule and tracing.

``python -m repro_torch.analysis --device cpu`` runs both, applies the
checked-in baseline (``src/repro_torch/analysis/baseline.txt``, empty),
writes ``artifacts/analysis/torch_report.json`` with ``--json`` and exits 1
on any finding not in the baseline.
"""
from .lint import run_lint  # noqa: F401
from .report import (Finding, load_baseline,  # noqa: F401
                     split_by_baseline, write_report)

__all__ = ["Finding", "load_baseline", "run_lint", "split_by_baseline",
           "write_report"]
