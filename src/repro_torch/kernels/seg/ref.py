"""Plain PyTorch version of the CSR segment max (``csrc/seg.cu``).

Contract, for every row ``r`` of an edge-indexed CSR and column ``c`` of the
``(n_msgs, d)`` float32 messages::

    max[r, c]   = max over row r's edges e of msgs[col[e], c]
    count[r, c] = the number of those edges with msgs[col[e], c] == max[r, c]

and an empty row gives max 0 and count 0 (the JAX package's ``where(out <=
NEG / 2, 0, out)`` over an empty segment). ``count`` is int32.

The scan follows the CSR's split plan (:func:`..spmm.ref.plan_reduce`): a
unit's edges in CSR order, each value replacing the running maximum with a
count of 1 when greater (or a NaN, which then stays), adding 1 when equal
(``-0 == +0``); a split row's partials combined left to right by the same
rule, their counts added. So the maximum is the first of the tied values in
CSR order, and neither it nor the count depends on the plan. The pairs
(max, count) ride in float64, which holds every float32 and every count
exactly.
"""
from __future__ import annotations

import torch

from ..spmm.ref import CSR, plan_reduce


def _take(acc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The scan's rule over ``(n, 2d)`` rows ``max | count``."""
    d = acc.shape[1] // 2
    m, c = acc[:, :d], acc[:, d:]
    tm, tc = t[:, :d], t[:, d:]
    gt = (tm > m) | torch.isnan(tm)
    return torch.cat([torch.where(gt, tm, m),
                      torch.where(gt, tc, torch.where(tm == m, c + tc, c))],
                     dim=1)


def seg_max_ref(msgs: torch.Tensor, csr: CSR
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(n_msgs, d) float32 messages -> ((n_rows, d) float32 max, (n_rows, d)
    int32 count) over each row's CSR edges, ``col`` naming the messages."""
    d = msgs.shape[1]
    col = csr.col.to(torch.int64)
    f64 = dict(dtype=torch.float64, device=msgs.device)
    ones = torch.ones((1, d), **f64)
    init = torch.cat([torch.full((d,), float("-inf"), **f64),
                      torch.zeros((d,), **f64)])
    out = plan_reduce(
        lambda e: torch.cat([msgs[col[e]].to(torch.float64),
                             ones.expand(e.shape[0], d)], dim=1),
        csr, 2 * d, torch.float64, msgs.device, reduce=_take, init=init)
    m, c = out[:, :d], out[:, d:]
    return (torch.where(c == 0, 0.0, m).to(torch.float32),
            c.to(torch.int32))
