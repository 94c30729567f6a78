"""Wrapper of the CSR segment max kernel (``csrc/seg.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``SEG_MAX.launches`` counts the
launches (one a call; a call runs a second CUDA kernel, the split rows'
combination, when the CSR has split rows).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import Kernel
from ..spmm.ref import CSR
from . import ref as _r

_P, _I = ctypes.c_void_p, ctypes.c_int

SEG_MAX = Kernel("seg_max_csr", "seg.cu",
                 [_P, _P, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P])


def seg_max(msgs: torch.Tensor, csr: CSR
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(max, count)`` of the (n_msgs, d) float32 messages over each row's
    CSR edges (``col`` names the messages): (n_rows, d) float32 and int32,
    0 and 0 for an empty row; see ``ref.py`` for the rule on ties."""
    if msgs.dim() != 2 or msgs.shape[0] != csr.n_cols:
        raise ValueError(f"msgs must be ({csr.n_cols}, d), got "
                         f"{tuple(msgs.shape)}")
    if msgs.device.type == "cpu":
        return _r.seg_max_ref(msgs, csr)
    if msgs.device.type != "cuda":
        raise ValueError(f"msgs must be on the CPU or a CUDA device, got "
                         f"{msgs.device}")
    if msgs.dtype != torch.float32 or not msgs.is_contiguous():
        raise ValueError("msgs must be contiguous float32")
    for name in ("col", "units", "long_rows", "long_ptr"):
        t = getattr(csr, name)
        if t.device != msgs.device or t.dtype != torch.int32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous int32 on "
                             f"{msgs.device}")
    n_rows, d = csr.n_rows, msgs.shape[1]
    dev = msgs.device
    out = torch.empty((n_rows, d), dtype=torch.float32, device=dev)
    cnt = torch.empty((n_rows, d), dtype=torch.int32, device=dev)
    part = torch.empty((csr.n_partials, d), dtype=torch.float32, device=dev)
    part_cnt = torch.empty((csr.n_partials, d), dtype=torch.int32,
                           device=dev)
    if n_rows and d:
        SEG_MAX(msgs.data_ptr(), csr.col.data_ptr(), csr.units.data_ptr(),
                csr.units.shape[0], csr.long_rows.data_ptr(),
                csr.long_ptr.data_ptr(), csr.long_rows.shape[0],
                part.data_ptr(), part_cnt.data_ptr(), out.data_ptr(),
                cnt.data_ptr(), n_rows, d,
                torch.cuda.current_stream(dev).cuda_stream)
    return out, cnt
