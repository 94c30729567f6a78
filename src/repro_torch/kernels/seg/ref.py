"""Plain PyTorch versions of the CSR segment max / min and their gradient
(``csrc/seg.cu``).

Contract, for every row ``r`` of an edge-indexed CSR and column ``c`` of the
``(n_msgs, d)`` float32 messages::

    max[r, c]   = max over row r's edges e of msgs[col[e], c]
    count[r, c] = the number of those edges with msgs[col[e], c] == max[r, c]

and an empty row gives max 0 and count 0 (the JAX package's ``where(out <=
NEG / 2, 0, out)`` over an empty segment). ``count`` is int32. The minimum
and its count follow the same rule with "less", and are bit for bit
``-seg_max_ref(-msgs)``: an empty row's minimum is -0.

The scan follows the CSR's split plan (:func:`..spmm.ref.plan_reduce`): a
unit's edges in CSR order, each value replacing the running extremum with a
count of 1 when greater (for the minimum: less), or when a NaN (which then
stays), and adding 1 when equal (``-0 == +0``); a split row's partials
combined left to right by the same rule, their counts added. So an extremum
is the first of its tied values in CSR order, and neither it nor the count
depends on the plan. The pairs (extremum, count) ride in float64, which
holds every float32 and every count exactly.
"""
from __future__ import annotations

import torch

from ..spmm.ref import CSR, plan_reduce


def _take(acc: torch.Tensor, t: torch.Tensor, beats=torch.gt
          ) -> torch.Tensor:
    """The scan's rule over ``(n, 2d)`` rows ``extremum | count``: ``beats``
    is ``torch.gt`` for the maximum, ``torch.lt`` for the minimum."""
    d = acc.shape[1] // 2
    m, c = acc[:, :d], acc[:, d:]
    tm, tc = t[:, :d], t[:, d:]
    gt = beats(tm, m) | torch.isnan(tm)
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


def _take_both(acc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """The scan's rule over ``(n, 4d)`` rows ``max | count | min | count``."""
    h = acc.shape[1] // 2
    return torch.cat([_take(acc[:, :h], t[:, :h]),
                      _take(acc[:, h:], t[:, h:], torch.lt)], dim=1)


def seg_max_min_ref(msgs: torch.Tensor, csr: CSR
                    ) -> tuple[torch.Tensor, ...]:
    """(n_msgs, d) float32 messages -> ``(max, count_max, min, count_min)``,
    each (n_rows, d), float32 / int32, over each row's CSR edges in one scan
    (``col`` naming the messages); an empty row gives +0, 0, -0, 0."""
    d = msgs.shape[1]
    col = csr.col.to(torch.int64)
    f64 = dict(dtype=torch.float64, device=msgs.device)
    ones = torch.ones((1, d), **f64)
    inf = torch.full((d,), float("inf"), **f64)
    zeros = torch.zeros((d,), **f64)
    init = torch.cat([-inf, zeros, inf, zeros])

    def term(e):
        m = msgs[col[e]].to(torch.float64)
        one = ones.expand(e.shape[0], d)
        return torch.cat([m, one, m, one], dim=1)
    out = plan_reduce(term, csr, 4 * d, torch.float64, msgs.device,
                      reduce=_take_both, init=init)
    mx, cx, mn, cn = out.split(d, dim=1)
    return (torch.where(cx == 0, 0.0, mx).to(torch.float32),
            cx.to(torch.int32),
            torch.where(cn == 0, -0.0, mn).to(torch.float32),
            cn.to(torch.int32))


def seg_max_min_vjp_ref(msgs: torch.Tensor, csr: CSR, mx: torch.Tensor,
                        cmx: torch.Tensor, mn: torch.Tensor,
                        cmn: torch.Tensor, g_max: torch.Tensor,
                        g_min: torch.Tensor, pad: torch.Tensor
                        ) -> torch.Tensor:
    """The gradient of the messages through ``seg_max_min_ref``: for edge
    ``e`` of row ``r``, ``m = msgs[col[e]]``::

        where(m == max[r], g_max[r] * (1 / count_max[r]), 0)
            + where(m == min[r], g_min[r] * (1 / count_min[r]), 0)

    (the reciprocal first, then the product, as JAX's ``updates_coef``; the
    two terms added in this order); the rows ``pad`` (no edge's) are 0."""
    col = csr.col.to(torch.int64)
    dst = torch.repeat_interleave(
        torch.arange(csr.n_rows, device=msgs.device),
        torch.diff(csr.row_ptr.to(torch.int64)), output_size=csr.nnz)
    m = msgs[col]

    def share(g, count):
        return (g * torch.reciprocal(count.to(g.dtype)))[dst]
    grad = torch.where(m == mx[dst], share(g_max, cmx), 0.0) \
        + torch.where(m == mn[dst], share(g_min, cmn), 0.0)
    out = torch.empty_like(msgs)
    out[col] = grad
    out[pad.to(torch.int64)] = 0.0
    return out
