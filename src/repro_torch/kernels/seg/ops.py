"""Wrappers of the CSR segment max / min kernels (``csrc/seg.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``SEG_MAX_MIN.launches`` and
``SEG_MAX_MIN_BWD.launches`` count the launches, one a call (a forward call
runs a second CUDA kernel, the split rows' combination, when the CSR has
split rows; a backward call one that zeroes the padded rows).
"""
from __future__ import annotations

import ctypes

import torch

from ..build import Kernel
from ..spmm.ref import CSR
from . import ref as _r

_P, _I, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

SEG_MAX_MIN = Kernel("seg_max_min_csr", "seg.cu",
                     [_P, _P, _P, _I, _P, _P, _I] + [_P] * 8 + [_I, _I, _P])
SEG_MAX_MIN_BWD = Kernel("seg_max_min_bwd_csr", "seg.cu",
                         [_P, _P, _P, _I, _P, _P, _I] + [_P] * 4
                         + [_P, _I64, _P, _I64, _P, _I, _P, _I, _I, _P])


def _on_card(msgs: torch.Tensor, csr: CSR) -> bool:
    """True for a CUDA tensor whose CSR is on its device; False for a CPU
    tensor; raises otherwise."""
    if msgs.dim() != 2 or msgs.shape[0] != csr.n_cols:
        raise ValueError(f"msgs must be ({csr.n_cols}, d), got "
                         f"{tuple(msgs.shape)}")
    if msgs.device.type == "cpu":
        return False
    if msgs.device.type != "cuda":
        raise ValueError(f"msgs must be on the CPU or a CUDA device, got "
                         f"{msgs.device}")
    if msgs.dtype != torch.float32 or not msgs.is_contiguous():
        raise ValueError("msgs must be contiguous float32")
    for name in ("col", "units", "long_rows", "long_ptr"):
        _int32_on(getattr(csr, name), name, msgs.device)
    return True


def _int32_on(t: torch.Tensor, name: str, device) -> None:
    if t.device != device or t.dtype != torch.int32 or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous int32 on {device}")


def seg_max_min(msgs: torch.Tensor, csr: CSR) -> tuple[torch.Tensor, ...]:
    """``(max, count_max, min, count_min)`` of the (n_msgs, d) float32
    messages over each row's CSR edges (``col`` names the messages): (n_rows,
    d) float32, int32, float32, int32; an empty row gives max +0, min -0 and
    counts 0. See ``ref.py`` for the rule on ties."""
    if not _on_card(msgs, csr):
        return _r.seg_max_min_ref(msgs, csr)
    n_rows, d = csr.n_rows, msgs.shape[1]

    def empty(n, dtype):
        return torch.empty((n, d), dtype=dtype, device=msgs.device)
    outs = [empty(n_rows, t) for t in (torch.float32, torch.int32) * 2]
    parts = [empty(csr.n_partials, t)
             for t in (torch.float32, torch.int32) * 2]
    if n_rows and d:
        SEG_MAX_MIN(msgs.data_ptr(), csr.col.data_ptr(), csr.units.data_ptr(),
                    csr.units.shape[0], csr.long_rows.data_ptr(),
                    csr.long_ptr.data_ptr(), csr.long_rows.shape[0],
                    *(t.data_ptr() for t in parts + outs), n_rows, d,
                    torch.cuda.current_stream(msgs.device).cuda_stream)
    return tuple(outs)


def seg_max_min_bwd(msgs: torch.Tensor, csr: CSR, mx: torch.Tensor,
                    cmx: torch.Tensor, mn: torch.Tensor, cmn: torch.Tensor,
                    g_max: torch.Tensor, g_min: torch.Tensor,
                    pad: torch.Tensor) -> torch.Tensor:
    """The (n_msgs, d) gradient of the messages given ``seg_max_min``'s
    outputs and the gradients ``g_max`` / ``g_min`` (n_rows, d) of its max
    and min (any row stride); ``pad`` (n_pad,) int32 names the message rows
    no edge reaches, which get 0. ``col`` and ``pad`` together name every
    message row once. See ``ref.py::seg_max_min_vjp_ref``."""
    shape = (csr.n_rows, msgs.shape[-1])
    for name, t in (("max", mx), ("count_max", cmx), ("min", mn),
                    ("count_min", cmn), ("g_max", g_max), ("g_min", g_min)):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if pad.dim() != 1 or csr.nnz + pad.shape[0] != csr.n_cols:
        raise ValueError(f"pad must name the {csr.n_cols - csr.nnz} message "
                         f"rows no edge reaches, got {tuple(pad.shape)}")
    if not _on_card(msgs, csr):
        return _r.seg_max_min_vjp_ref(msgs, csr, mx, cmx, mn, cmn, g_max,
                                      g_min, pad)
    dev = msgs.device
    for name, t, dtype in (("max", mx, torch.float32),
                           ("count_max", cmx, torch.int32),
                           ("min", mn, torch.float32),
                           ("count_min", cmn, torch.int32)):
        if t.device != dev or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on {dev}")
    gs = []
    for name, g in (("g_max", g_max), ("g_min", g_min)):
        if g.device != dev or g.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
        gs.append(g if g.stride(1) == 1 else g.contiguous())
    _int32_on(pad, "pad", dev)
    n_rows, d = shape
    out = torch.empty_like(msgs)
    if d:
        SEG_MAX_MIN_BWD(msgs.data_ptr(), csr.col.data_ptr(),
                        csr.units.data_ptr(), csr.units.shape[0],
                        csr.long_rows.data_ptr(), csr.long_ptr.data_ptr(),
                        csr.long_rows.shape[0], mx.data_ptr(),
                        cmx.data_ptr(), mn.data_ptr(), cmn.data_ptr(),
                        gs[0].data_ptr(), gs[0].stride(0), gs[1].data_ptr(),
                        gs[1].stride(0), pad.data_ptr(), pad.shape[0],
                        out.data_ptr(), n_rows, d,
                        torch.cuda.current_stream(dev).cuda_stream)
    return out
