"""CSR layout + plain PyTorch version of the SpMM aggregation kernel.

Contract (the GNN aggregation, Alg. 1 line 15): for every destination row ``r``

    out[r, :] = sum_{e in row_ptr[r] .. row_ptr[r+1]}  w[e] * table[col[e], :]

with the edges of a row in CSR order. GCN normalization rides in ``w``. The
plain version repeats the kernel's arithmetic: every row's sum starts at 0
and adds ``w * t`` (the product rounded first) edge by edge in CSR order, so
the two agree bit for bit on the CPU and on CUDA alike.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse rows: ``row_ptr`` (n_rows+1,) int32, ``col`` (nnz,)
    int32 in ``[0, n_cols)``, ``w`` (nnz,) float32."""

    row_ptr: torch.Tensor
    col: torch.Tensor
    w: torch.Tensor
    n_cols: int

    @property
    def n_rows(self) -> int:
        return int(self.row_ptr.shape[0]) - 1

    @property
    def nnz(self) -> int:
        return int(self.col.shape[0])

    def to(self, device) -> "CSR":
        return CSR(self.row_ptr.to(device), self.col.to(device),
                   self.w.to(device), self.n_cols)


def csr_from_edges(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   n_rows: int, n_cols: int) -> CSR:
    """Host-side: edge list (messages src -> dst, weight w) -> CSR over the
    destinations. Edges are sorted by destination, keeping their original
    order within a row."""
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
               int(n_cols))


def csr_from_padded(idx: np.ndarray, w: np.ndarray, n_src: int) -> CSR:
    """The JAX kernel's padded CSR ``(n_rows, max_deg)`` index + weight ->
    CSR keeping every slot (padding slots carry ``w = 0``), so both compute
    ``out[r] = sum_s w[r, s] * table[idx[r, s]]``."""
    idx = np.asarray(idx)
    n_rows, max_deg = idx.shape
    dst = np.repeat(np.arange(n_rows), max_deg)
    return csr_from_edges(idx.reshape(-1), dst, np.asarray(w).reshape(-1),
                          n_rows, n_src)


def spmm_ref(table: torch.Tensor, csr: CSR) -> torch.Tensor:
    """(n_cols, d) float32 table -> (n_rows, d) float32.

    Step ``s`` adds the ``s``-th edge of every row that has one, so each row
    sums in CSR order and every ``index_add_`` hits each row at most once (no
    order left to the device). Rows are sorted by degree, so the rows still
    active at step ``s`` are a prefix."""
    deg = (csr.row_ptr[1:] - csr.row_ptr[:-1]).to(torch.int64)
    order = torch.argsort(deg, descending=True, stable=True)
    start = csr.row_ptr[:-1].to(torch.int64)[order]
    desc = deg[order].cpu().numpy()
    max_deg = int(desc[0]) if desc.size else 0
    n_active = np.searchsorted(-desc, -np.arange(max_deg), side="left")
    col = csr.col.to(torch.int64)
    out = torch.zeros((csr.n_rows, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    for s in range(max_deg):
        n = int(n_active[s])
        e = start[:n] + s
        out.index_add_(0, order[:n], csr.w[e][:, None] * table[col[e]])
    return out
