"""Wrappers of the CSR SpMM kernels (``csrc/spmm.cu``).

A CPU table goes to the plain version in ``ref.py``; a CUDA table launches the
kernel on the current stream or raises. ``SPMM.launches`` and
``SPMM_HEADS.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import Kernel
from . import ref as _r
from .ref import CSR

_P, _I = ctypes.c_void_p, ctypes.c_int

SPMM = Kernel("spmm_csr", "spmm.cu",
              [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P])
SPMM_HEADS = Kernel("spmm_csr_heads", "spmm.cu",
                    [_P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _P, _P, _I, _I,
                     _P])
# the most heads spmm_csr_heads takes (its weights are staged per warp)
CUDA_MAX_HEADS = 8


def _check_cuda(table: torch.Tensor, csr: CSR,
                w: Optional[torch.Tensor] = None) -> None:
    if table.device.type != "cuda":
        raise ValueError(f"table must be on the CPU or a CUDA device, got "
                         f"{table.device}")
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("table must be contiguous float32")
    named = [("col", csr.col, torch.int32), ("units", csr.units, torch.int32),
             ("long_rows", csr.long_rows, torch.int32),
             ("long_ptr", csr.long_ptr, torch.int32),
             ("w", csr.w if w is None else w, torch.float32)]
    for name, t, dtype in named:
        if t.device != table.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on "
                             f"{table.device}")


def _check_table(table: torch.Tensor, csr: CSR) -> None:
    if table.dim() != 2 or table.shape[0] != csr.n_cols:
        raise ValueError(f"table must be ({csr.n_cols}, d), got "
                         f"{tuple(table.shape)}")


def _launch(kernel: Kernel, table: torch.Tensor, csr: CSR,
            w_args: tuple) -> torch.Tensor:
    n_rows, d = csr.n_rows, table.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=table.device)
    # the split rows' partial sums: a workspace the second pass reads
    part = torch.empty((csr.n_partials, d), dtype=torch.float32,
                       device=table.device)
    if n_rows and d:
        kernel(table.data_ptr(), csr.col.data_ptr(), *w_args,
               csr.units.data_ptr(), csr.units.shape[0],
               csr.long_rows.data_ptr(), csr.long_ptr.data_ptr(),
               csr.long_rows.shape[0], part.data_ptr(), out.data_ptr(),
               n_rows, d, torch.cuda.current_stream(table.device).cuda_stream)
    return out


def spmm(table: torch.Tensor, csr: CSR) -> torch.Tensor:
    """``out[r] = sum_e w[e] * table[col[e]]`` over row ``r``'s CSR edges:
    (n_cols, d) float32 -> (n_rows, d) float32, in the order that ``ref.py``
    fixes."""
    _check_table(table, csr)
    if table.device.type == "cpu":
        return _r.spmm_ref(table, csr)
    _check_cuda(table, csr)
    return _launch(SPMM, table, csr, (csr.w.data_ptr(),))


def spmm_heads(table: torch.Tensor, csr: CSR, w: torch.Tensor,
               w_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-head SpMM: ``out[r, c] = sum_e w[w_idx[e], c // dh] *
    table[col[e], c]`` over the (n_cols, H * dh) table's columns in H groups
    of dh (``csr.w`` is not read). ``w_idx`` (nnz,) int32 picks edge ``e``'s
    row of ``w`` (n_w, H); without it ``w`` is (nnz, H) in CSR order. The
    order of :func:`spmm`, which is its ``H = 1`` case bit for bit."""
    _check_table(table, csr)
    if w_idx is not None and (
            w_idx.shape != (csr.nnz,) or w_idx.dtype != torch.int32
            or w_idx.device != table.device or not w_idx.is_contiguous()):
        raise ValueError(f"w_idx must be contiguous int32 ({csr.nnz},) on "
                         f"{table.device}, got {w_idx.dtype} "
                         f"{tuple(w_idx.shape)} on {w_idx.device}")
    rows = csr.nnz if w_idx is None else w.shape[0]
    if w.dim() != 2 or w.shape[0] != rows or w.shape[1] < 1 \
            or table.shape[1] % w.shape[1]:
        raise ValueError(f"w must be ({rows}, H) with H dividing the "
                         f"table's width {table.shape[1]}, got "
                         f"{tuple(w.shape)}")
    if table.device.type == "cpu":
        return _r.spmm_heads_ref(table, csr, w, w_idx)
    _check_cuda(table, csr, w)
    if w.shape[1] > CUDA_MAX_HEADS:
        raise ValueError(f"the CUDA kernel takes at most {CUDA_MAX_HEADS} "
                         f"heads, got {w.shape[1]}")
    return _launch(SPMM_HEADS, table, csr, (
        w.data_ptr(), None if w_idx is None else w_idx.data_ptr(),
        w.shape[1]))
