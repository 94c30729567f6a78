"""Plain PyTorch versions of GAT's CSR kernels (``csrc/gat.cu``).

For destination row ``r`` and head ``h`` over the row's CSR edges ``e``
(source ``col[e]``), with ``x_e = s_src[col_e, h] + s_dst[r, h]``:

* :func:`gat_softmax_ref` — ``score = x >= 0 ? x : 0.2 x``; ``alpha_e =
  exp(score_e - max_row score) / max(sum_row exp(...), 1e-16)`` (``exp``
  rounded from float64: :func:`exp_rounded`);
* :func:`gat_softmax_bwd_ref` — ``c = sum_row alpha dalpha``, ``dx_e =
  alpha_e (dalpha_e - c) (x_e >= 0 ? 1 : 0.2)``, ``d s_dst[r] = sum_row
  dx``;
* :func:`row_sums_t_ref` — over the transposed CSR, ``d s_src[c] =
  sum_row dx[perm_t[e']]``;
* :func:`sddmm_heads_ref` — ``dalpha[e, h] = sum_{k < dh} dout[r, h*dh +
  k] * table[col_e, h*dh + k]``, ``k`` in order.

Every sum runs in the order the CSR's plan fixes (``spmm.ref.plan_reduce``:
a row edge by edge from 0, a split row by segments whose partials add left
to right), each product rounded before its add, and no ``index_add_`` or
``scatter_*``: the kernels follow the same order, so on the card the two
agree bit for bit where ``exp`` does. The JAX package computes the same
functions with ``segment_max`` / ``segment_sum`` over the edge list
(``repro/models/gnn/blocks.py::edge_softmax``), in another order.
"""
from __future__ import annotations

import torch

from ..spmm.ref import CSR, plan_reduce

NEG_SLOPE = 0.2
Z_MIN = 1e-16


def edge_rows(csr: CSR) -> torch.Tensor:
    """(nnz,) int64: the row of every CSR edge."""
    deg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).to(torch.int64)
    return torch.repeat_interleave(
        torch.arange(csr.n_rows, device=csr.col.device), deg)


def _x(s_src, s_dst, csr, rows):
    return s_src[csr.col.to(torch.int64)] + s_dst[rows]


def _rows_reduce(vals: torch.Tensor, csr: CSR, reduce=torch.add,
                 init: float = 0.0) -> torch.Tensor:
    return plan_reduce(lambda e: vals[e], csr, vals.shape[1], vals.dtype,
                       vals.device, reduce, init)


def exp_rounded(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of float32 ``x``, taken in float64 and rounded to float32.
    PyTorch's CPU loop takes a tensor's last, partial vector with the scalar
    ``exp``, which may differ by an ulp from the vectorized one: in float32
    an edge's value would depend on where the tensor ends (one partition's
    edges, or the whole stack's); rounded from float64 it does not."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def gat_softmax_ref(s_src: torch.Tensor, s_dst: torch.Tensor,
                    csr: CSR) -> torch.Tensor:
    """(n_src, H), (n_rows, H) float32 -> alpha (nnz, H) in CSR order."""
    rows = edge_rows(csr)
    x = _x(s_src, s_dst, csr, rows)
    score = torch.where(x >= 0, x, NEG_SLOPE * x)
    m = _rows_reduce(score, csr, torch.maximum, float("-inf"))
    ex = exp_rounded(score - m[rows])
    z = _rows_reduce(ex, csr)
    return ex / torch.clamp(z, min=Z_MIN)[rows]


def gat_softmax_bwd_ref(alpha: torch.Tensor, dalpha: torch.Tensor,
                        s_src: torch.Tensor, s_dst: torch.Tensor,
                        csr: CSR) -> tuple[torch.Tensor, torch.Tensor]:
    """-> (dx (nnz, H), d s_dst (n_rows, H)): the gradient of the scores'
    pre-activation and its row sums."""
    rows = edge_rows(csr)
    x = _x(s_src, s_dst, csr, rows)
    c = _rows_reduce(alpha * dalpha, csr)
    dx = alpha * (dalpha - c[rows])
    dx = torch.where(x < 0, NEG_SLOPE * dx, dx)
    return dx, _rows_reduce(dx, csr)


def row_sums_t_ref(dx: torch.Tensor, csr_t: CSR,
                   perm_t: torch.Tensor) -> torch.Tensor:
    """dx (nnz, H) in forward order -> (csr_t.n_rows, H): row ``c`` sums
    ``dx[perm_t[e']]`` over its transposed edges ``e'`` (``d s_src``)."""
    return _rows_reduce(dx[perm_t.to(torch.int64)], csr_t)


def sddmm_heads_ref(g: torch.Tensor, table: torch.Tensor, csr: CSR,
                    n_heads: int) -> torch.Tensor:
    """g (n_rows, H*dh), table (n_src, H*dh) -> (nnz, H)."""
    rows = edge_rows(csr)
    dh = g.shape[1] // n_heads
    gr = g.view(-1, n_heads, dh)[rows]
    tc = table.view(-1, n_heads, dh)[csr.col.to(torch.int64)]
    acc = torch.zeros(gr.shape[:2], dtype=g.dtype, device=g.device)
    for k in range(dh):
        acc = acc + gr[..., k] * tc[..., k]
    return acc
