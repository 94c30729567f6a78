"""CSR layout, its work plan, and the plain PyTorch version of the SpMM
aggregation kernel.

Contract (the GNN aggregation, Alg. 1 line 15): for every destination row ``r``

    out[r, :] = sum_{e in row_ptr[r] .. row_ptr[r+1]}  w[e] * table[col[e], :]

with the edges of a row in CSR order and each product rounded before its
add. GCN normalization rides in ``w``. The order of the sums is fixed by the
CSR alone:

* a row with at most :data:`SEGMENT` edges sums from 0, edge by edge;
* a longer row is cut into row-relative segments ``[e0 + k*SEGMENT,
  min(e0 + (k+1)*SEGMENT, e1))``; each segment sums from 0, edge by edge,
  and the partials combine left to right, ``((p0 + p1) + p2) + ...``.

The kernel and :func:`spmm_ref` both follow it, so they agree bit for bit on
the CPU and on CUDA alike, and one CSR gives the same bits on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

# Edges per work unit: rows longer than this are split into segments.
SEGMENT = 128


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse rows: ``row_ptr`` (n_rows+1,) int32, ``col`` (nnz,)
    int32 in ``[0, n_cols)``, ``w`` (nnz,) float32; and the work plan of
    :func:`split_plan`: ``units`` (n_units, 3) int32, ``long_rows``
    (n_long,) int32, ``long_ptr`` (n_long+1,) int32, ``n_partials``."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    w: torch.Tensor
    n_cols: int
    units: torch.Tensor
    long_rows: torch.Tensor
    long_ptr: torch.Tensor
    n_partials: int

    @property
    def n_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "CSR":
        return CSR(self.row_ptr.to(device), self.col.to(device),
                   self.w.to(device), self.n_cols, self.units.to(device),
                   self.long_rows.to(device), self.long_ptr.to(device),
                   self.n_partials)


def split_plan(row_ptr: np.ndarray, segment: int = SEGMENT):
    """The work units of a CSR, built once on the host.

    Returns ``(units, long_rows, long_ptr, n_partials)``. Each unit is
    ``(e_begin, e_end, target)``: a whole row of at most ``segment`` edges
    (``target`` is the row, ``< n_rows``), or one segment of a longer row
    (``target`` is ``n_rows + slot``, the segment's partial-sum slot). No
    unit has more than ``segment`` edges, so no unit of a hub starts last and
    runs alone. Units are in CSR order (a split row's segments in place, in
    segment order): neighbouring rows share neighbours, so warps that run
    together find their table rows in L2. ``long_rows`` are the split rows
    in row order; the partials of ``long_rows[i]`` are slots ``long_ptr[i] ..
    long_ptr[i+1]``, in segment order. An empty row is one empty unit (it
    writes zeros)."""
    row_ptr = np.asarray(row_ptr, dtype=np.int64)
    deg = np.diff(row_ptr)
    n_rows = deg.size
    n_seg = np.maximum(1, -(-deg // segment))
    long = np.nonzero(n_seg > 1)[0]
    long_ptr = np.zeros(long.size + 1, dtype=np.int64)
    np.cumsum(n_seg[long], out=long_ptr[1:])
    slot0 = np.full(n_rows, -1, dtype=np.int64)
    slot0[long] = long_ptr[:-1]
    row = np.repeat(np.arange(n_rows), n_seg)
    k = np.arange(row.size) - np.repeat(np.cumsum(n_seg) - n_seg, n_seg)
    e0 = row_ptr[row] + k * segment
    e1 = np.minimum(e0 + segment, row_ptr[row + 1])
    target = np.where(slot0[row] >= 0, n_rows + slot0[row] + k, row)
    if n_rows + long_ptr[-1] >= 2 ** 31:
        raise ValueError("the CSR kernel indexes rows and partials with int32")
    units = np.stack([e0, e1, target], axis=1)
    return (torch.from_numpy(units.astype(np.int32)),
            torch.from_numpy(long.astype(np.int32)),
            torch.from_numpy(long_ptr.astype(np.int32)), int(long_ptr[-1]))


def csr_from_edges(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   n_rows: int, n_cols: int) -> CSR:
    """Host-side: edge list (messages src -> dst, weight w) -> CSR over the
    destinations, with its work plan. Edges are sorted by destination,
    keeping their original order within a row."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if src.size and (src.min() < 0 or src.max() >= n_cols
                     or dst.min() < 0 or dst.max() >= n_rows):
        raise ValueError("edge index out of range for the CSR shape")
    order = np.argsort(dst, kind="stable")
    row_ptr = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n_rows), out=row_ptr[1:])
    if row_ptr[-1] >= 2 ** 31:
        raise ValueError("the CSR kernel indexes edges with int32")
    return CSR(torch.from_numpy(row_ptr.astype(np.int32)),
               torch.from_numpy(src[order].astype(np.int32)),
               torch.from_numpy(np.asarray(w, dtype=np.float32)[order]),
               int(n_cols), *split_plan(row_ptr))


def csr_from_padded(idx: np.ndarray, w: np.ndarray, n_src: int) -> CSR:
    """The JAX kernel's padded CSR ``(n_rows, max_deg)`` index + weight ->
    CSR keeping every slot (padding slots carry ``w = 0``), so both compute
    ``out[r] = sum_s w[r, s] * table[idx[r, s]]``."""
    idx = np.asarray(idx)
    n_rows, max_deg = idx.shape
    dst = np.repeat(np.arange(n_rows), max_deg)
    return csr_from_edges(idx.reshape(-1), dst, np.asarray(w).reshape(-1),
                          n_rows, n_src)


def plan_reduce(term, csr: CSR, width: int, dtype, device,
                reduce=torch.add, init: float = 0.0) -> torch.Tensor:
    """The row reductions of a CSR in the order its plan fixes: ``out[r] =
    reduce(... reduce(reduce(init, t_0), t_1) ..., t_k)`` over row ``r``'s
    edges, with ``term(e)`` the ``(len(e), width)`` terms of the edges
    ``e``; a split row reduces each segment so, then its partials left to
    right. ``init`` is a number or a ``(width,)`` tensor. Returns
    ``(n_rows, width)``.

    Step ``s`` takes the ``s``-th edge of every unit that has one; with the
    units sorted heaviest first, those still active are a prefix and each
    step is a plain slice update (no order left to the device). Whole rows
    are then copied out, and split rows' partials combined left to right,
    one segment per step, over the rows that still have one."""
    units = csr.units.to(torch.int64)
    length = units[:, 1] - units[:, 0]
    units = units[torch.argsort(length, descending=True, stable=True)]
    n_rows = csr.n_rows
    desc = (units[:, 1] - units[:, 0]).cpu().numpy()
    steps = int(desc[0]) if desc.size else 0
    n_active = np.searchsorted(-desc, -np.arange(steps), side="left")
    buf = torch.empty((units.shape[0], width), dtype=dtype, device=device)
    buf[:] = init
    for s in range(steps):
        n = int(n_active[s])
        buf[:n] = reduce(buf[:n], term(units[:n, 0] + s))
    out = torch.empty((n_rows, width), dtype=dtype, device=device)
    target = units[:, 2]
    whole = target < n_rows
    out[target[whole]] = buf[whole]
    if csr.long_rows.numel():
        part = torch.empty((csr.n_partials, width), dtype=dtype,
                           device=device)
        part[target[~whole] - n_rows] = buf[~whole]
        ptr = csr.long_ptr.to(torch.int64)
        n_seg = ptr[1:] - ptr[:-1]
        acc = part[ptr[:-1]]
        for k in range(1, int(n_seg.max())):
            more = n_seg > k
            acc[more] = reduce(acc[more], part[ptr[:-1][more] + k])
        out[csr.long_rows.to(torch.int64)] = acc
    return out


def spmm_ref(table: torch.Tensor, csr: CSR) -> torch.Tensor:
    """(n_cols, d) float32 table -> (n_rows, d) float32: the sums of
    :func:`plan_reduce`, each term ``w[e] * table[col[e]]`` rounded before
    its add."""
    col = csr.col.to(torch.int64)
    return plan_reduce(lambda e: csr.w[e][:, None] * table[col[e]], csr,
                       table.shape[1], table.dtype, table.device)


def spmm_heads_ref(table: torch.Tensor, csr: CSR, w: torch.Tensor,
                   w_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-head SpMM: ``w`` (n_w, H) replaces ``csr.w``, edge ``e``
    taking row ``w_idx[e]`` of it (row ``e`` without ``w_idx``, ``w`` then
    (nnz, H) in CSR order); column ``c`` of the (n_cols, H * dh) table is
    weighted by ``w[w_idx[e], c // dh]``: ``out[r, h*dh + k] = sum_e
    w[w_idx[e], h] * table[col[e], h*dh + k]``, in the order of
    :func:`spmm_ref`, which is its ``H = 1`` case bit for bit."""
    n_heads, d = w.shape[1], table.shape[1]
    col = csr.col.to(torch.int64)
    idx = None if w_idx is None else w_idx.to(torch.int64)

    def term(e):
        t = table[col[e]].view(-1, n_heads, d // n_heads)
        we = w[e] if idx is None else w[idx[e]]
        return (we[:, :, None] * t).view(-1, d)
    return plan_reduce(term, csr, d, table.dtype, table.device)
