"""Wrappers of the Low-bit Module kernels (``csrc/quant.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``QUANTIZE_PACK.launches`` and
``UNPACK_DEQUANTIZE.launches`` count the launches.

Scale and zero travel as float32 or bfloat16 (``SCALE_DTYPES``). The kernels
write and read either directly; the plain versions compute in float32 and
cast, which rounds the same way (to nearest, ties to even).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..build import Kernel
from . import ref as _r

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int

QUANTIZE_PACK = Kernel("quantize_pack", "quant.cu",
                       [_P, _P, _P, _P, _P, _I64, _I, _I, _I, _P])
UNPACK_DEQUANTIZE = Kernel("unpack_dequantize", "quant.cu",
                           [_P, _P, _P, _P, _I64, _I, _I, _I, _P])
SCALE_DTYPES = (torch.float32, torch.bfloat16)


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


def _check_scale_dtype(dtype: torch.dtype) -> None:
    if dtype not in SCALE_DTYPES:
        raise ValueError(f"scale and zero must be one of {SCALE_DTYPES}, got "
                         f"{dtype}")


def quantize_pack_rows(h: torch.Tensor, u: Optional[torch.Tensor],
                       bits: int = 1,
                       scale_dtype: torch.dtype = torch.float32):
    """(rows, d) float32 + (rows, d) uniform[0,1) noise, or ``None`` for
    deterministic rounding -> (packed (rows, ceil(d*bits/8)) uint8,
    scale (rows,), zero (rows,)), scale and zero in ``scale_dtype``."""
    if bits not in _r.KERNEL_BITS:
        raise ValueError(f"the quantize kernel packs bits {_r.KERNEL_BITS}, "
                         f"got {bits}")
    _check_scale_dtype(scale_dtype)
    if h.device.type == "cpu":
        packed, scale, zero = _r.quantize_pack_ref(h, u, bits)
        return packed, scale.to(scale_dtype), zero.to(scale_dtype)
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
    scale = torch.empty(rows, dtype=scale_dtype, device=h.device)
    zero = torch.empty(rows, dtype=scale_dtype, device=h.device)
    if rows and d:
        QUANTIZE_PACK(h.data_ptr(), None if u is None else u.data_ptr(),
                      packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                      rows, d, bits, scale_dtype == torch.bfloat16,
                      torch.cuda.current_stream(h.device).cuda_stream)
    return packed, scale, zero


def dequantize_rows(packed: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(rows, ceil(d*bits/8)) uint8 + (rows,) scale/zero, both float32 or
    both bfloat16 -> (rows, d) f32."""
    if bits not in _r.KERNEL_BITS:
        raise ValueError(f"the dequantize kernel unpacks bits "
                         f"{_r.KERNEL_BITS}, got {bits}")
    _check_scale_dtype(scale.dtype)
    if zero.dtype != scale.dtype:
        raise ValueError(f"scale and zero must share a dtype, got "
                         f"{scale.dtype} and {zero.dtype}")
    if packed.device.type == "cpu":
        return _r.unpack_dequantize_ref(packed, scale.to(torch.float32),
                                        zero.to(torch.float32), bits, d)
    if packed.dim() != 2:
        raise ValueError(f"packed must be (rows, w), got {tuple(packed.shape)}")
    rows = packed.shape[0]
    _check_cuda("packed", packed, torch.uint8, (rows, _r.packed_width(d, bits)))
    _check_cuda("scale", scale, scale.dtype, (rows,))
    _check_cuda("zero", zero, scale.dtype, (rows,))
    if not packed.device == scale.device == zero.device:
        raise ValueError("packed, scale and zero must be on one device")
    out = torch.empty((rows, d), dtype=torch.float32, device=packed.device)
    if rows and d:
        UNPACK_DEQUANTIZE(packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
                          out.data_ptr(), rows, d, bits,
                          scale.dtype == torch.bfloat16,
                          torch.cuda.current_stream(packed.device).cuda_stream)
    return out
