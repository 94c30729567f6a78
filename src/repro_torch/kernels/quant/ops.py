"""Wrappers of the Low-bit Module kernels (``csrc/quant.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``QUANTIZE_PACK.launches`` and
``UNPACK_DEQUANTIZE.launches`` count the launches.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import Kernel
from . import ref as _r

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

QUANTIZE_PACK = Kernel("quantize_pack", "quant.cu",
                       [_P, _P, _P, _P, _P, _I64, _I, _I, _P])
UNPACK_DEQUANTIZE = Kernel("unpack_dequantize", "quant.cu",
                           [_P, _P, _P, _P, _I64, _I, _I, _P])


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be on the CPU or a CUDA device, got "
                         f"{t.device}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous {dtype}, got {t.dtype}"
                         f"{'' if t.is_contiguous() else ' (strided)'}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")


def quantize_pack_rows(h: torch.Tensor, u: Optional[torch.Tensor],
                       bits: int = 1):
    """(rows, d) float32 + (rows, d) uniform[0,1) noise, or ``None`` for
    deterministic rounding -> (packed (rows, ceil(d*bits/8)) uint8,
    scale (rows,) f32, zero (rows,) f32)."""
    if bits not in _r.KERNEL_BITS:
        raise ValueError(f"the quantize kernel packs bits {_r.KERNEL_BITS}, "
                         f"got {bits}")
    if h.device.type == "cpu":
        return _r.quantize_pack_ref(h, u, bits)
    if h.dim() != 2:
        raise ValueError(f"h must be (rows, d), got {tuple(h.shape)}")
    _check_cuda("h", h, torch.float32)
    if u is not None:
        _check_cuda("u", u, torch.float32, h.shape)
        if u.device != h.device:
            raise ValueError("u and h must be on one device")
    rows, d = h.shape
    packed = torch.empty((rows, _r.packed_width(d, bits)), dtype=torch.uint8,
                         device=h.device)
    scale = torch.empty(rows, dtype=torch.float32, device=h.device)
    zero = torch.empty(rows, dtype=torch.float32, device=h.device)
    if rows and d:
        QUANTIZE_PACK(h.data_ptr(), None if u is None else u.data_ptr(),
                      packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                      rows, d, bits,
                      torch.cuda.current_stream(h.device).cuda_stream)
    return packed, scale, zero


def dequantize_rows(packed: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(rows, ceil(d*bits/8)) uint8 + (rows,) f32 scale/zero -> (rows, d) f32."""
    if bits not in _r.KERNEL_BITS:
        raise ValueError(f"the dequantize kernel unpacks bits "
                         f"{_r.KERNEL_BITS}, got {bits}")
    if packed.device.type == "cpu":
        return _r.unpack_dequantize_ref(packed, scale, zero, bits, d)
    if packed.dim() != 2:
        raise ValueError(f"packed must be (rows, w), got {tuple(packed.shape)}")
    rows = packed.shape[0]
    _check_cuda("packed", packed, torch.uint8, (rows, _r.packed_width(d, bits)))
    _check_cuda("scale", scale, torch.float32, (rows,))
    _check_cuda("zero", zero, torch.float32, (rows,))
    if not packed.device == scale.device == zero.device:
        raise ValueError("packed, scale and zero must be on one device")
    out = torch.empty((rows, d), dtype=torch.float32, device=packed.device)
    if rows and d:
        UNPACK_DEQUANTIZE(packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                          out.data_ptr(), rows, d, bits,
                          torch.cuda.current_stream(packed.device).cuda_stream)
    return out
