"""Wrapper of the CSR SpMM kernel (``csrc/spmm.cu``).

A CPU table goes to the plain version in ``ref.py``; a CUDA table launches the
kernel on the current stream or raises. ``SPMM.launches`` counts the launches.
"""
from __future__ import annotations

import ctypes

import torch

from ..build import Kernel
from . import ref as _r
from .ref import CSR

_P, _I = ctypes.c_void_p, ctypes.c_int

SPMM = Kernel("spmm_csr", "spmm.cu",
              [_P, _P, _P, _P, _I, _P, _P, _I, _P, _P, _I, _I, _P])


def spmm(table: torch.Tensor, csr: CSR) -> torch.Tensor:
    """``out[r] = sum_e w[e] * table[col[e]]`` over row ``r``'s CSR edges:
    (n_cols, d) float32 -> (n_rows, d) float32, in the order that ``ref.py``
    fixes."""
    if table.dim() != 2 or table.shape[0] != csr.n_cols:
        raise ValueError(f"table must be ({csr.n_cols}, d), got "
                         f"{tuple(table.shape)}")
    if table.device.type == "cpu":
        return _r.spmm_ref(table, csr)
    if table.device.type != "cuda":
        raise ValueError(f"table must be on the CPU or a CUDA device, got "
                         f"{table.device}")
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise ValueError("table must be contiguous float32")
    for name, dtype in (("col", torch.int32), ("w", torch.float32),
                        ("units", torch.int32), ("long_rows", torch.int32),
                        ("long_ptr", torch.int32)):
        t = getattr(csr, name)
        if t.device != table.device or t.dtype != dtype \
                or not t.is_contiguous():
            raise ValueError(f"csr.{name} must be contiguous {dtype} on "
                             f"{table.device}")
    n_rows, d = csr.n_rows, table.shape[1]
    out = torch.empty((n_rows, d), dtype=torch.float32, device=table.device)
    # the split rows' partial sums: a workspace the second pass reads
    part = torch.empty((csr.n_partials, d), dtype=torch.float32,
                       device=table.device)
    if n_rows and d:
        SPMM(table.data_ptr(), csr.col.data_ptr(), csr.w.data_ptr(),
             csr.units.data_ptr(), csr.units.shape[0],
             csr.long_rows.data_ptr(), csr.long_ptr.data_ptr(),
             csr.long_rows.shape[0], part.data_ptr(), out.data_ptr(),
             n_rows, d, torch.cuda.current_stream(table.device).cuda_stream)
    return out
