"""The numbers that decide ``correct`` for a training cell.

The program's warm-up steps against the reference's, from the same graph,
weights and noise streams:

* ``loss``: the largest gap of a step's loss, over the reference's first
  loss (a loss that training has all but driven to zero in a few steps
  would make a gap over itself the noise of a tiny number);
* ``grad``: the first step's gradient as the optimizer got it, by the worst
  leaf: the gap between the two norms over the larger of the reference's
  norm of that leaf and of the median leaf;
* ``delta``: the parameters' change over the steps, by the worst leaf
  in the same way, over the leaves whose reference gradient is at least a
  thousandth of the median leaf's (a leaf whose gradient is nought to
  rounding moves under Adam by round-off alone).
"""
from __future__ import annotations

import math
import statistics

import torch

MOVING_LEAF = 1e-3


def _norms(tree: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tree.items()}


def _leaf_gaps(prog: dict, ref: dict, keys) -> list:
    med = statistics.median(ref[k] for k in keys)
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys]


def training_gaps(prog: dict, ref: dict, params0: dict) -> dict:
    """``prog`` and ``ref`` hold ``losses`` (one a step), ``grad0`` and
    ``params`` (leaf name -> tensor); ``params0`` the starting weights.
    Besides the three numbers above: ``loss0``, the first step's loss gap
    alone, and ``grad_med`` / ``delta_med``, the median leaf's gaps."""
    scale = max(abs(ref["losses"][0]), 1e-30)
    gaps = [abs(a - b) for a, b in zip(prog["losses"], ref["losses"])]
    finite = all(math.isfinite(v) for v in prog["losses"])
    g_ref = _norms(ref["grad0"])
    grad = _leaf_gaps(_norms(prog["grad0"]), g_ref, list(g_ref))
    g_med = statistics.median(g_ref.values())
    moving = [k for k in g_ref if g_ref[k] >= MOVING_LEAF * g_med]
    d_prog = _norms({k: prog["params"][k] - params0[k] for k in moving})
    d_ref = _norms({k: ref["params"][k] - params0[k] for k in moving})
    delta = _leaf_gaps(d_prog, d_ref, moving)
    return {"loss": max(gaps) / scale if finite else math.inf,
            "loss0": gaps[0] / scale if finite else math.inf,
            "grad": max(grad), "grad_med": statistics.median(grad),
            "delta": max(delta), "delta_med": statistics.median(delta)}


def judge(gaps: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: every gap finite and at or
    below its limit."""
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
