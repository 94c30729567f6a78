"""Plain PyTorch version of the fused quantize+bitpack / unpack+dequantize kernels.

The same I/O contract as ``csrc/quant.cu`` (flat 2-D buffers, noise passed in
explicitly) and the same arithmetic in the same order as the JAX reference
(``repro/kernels/quant/ref.py``), so the CPU tests hold it to JAX bit for bit
and ``chip_smoke.py`` holds the CUDA kernel to it on the card.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

KERNEL_BITS = (1, 2, 4, 8)


def lanes_per_byte(bits: int) -> int:
    assert bits in KERNEL_BITS
    return 8 // bits


def packed_width(d: int, bits: int) -> int:
    k = lanes_per_byte(bits)
    return (d + k - 1) // k


def pack_lanes(q: torch.Tensor, bits: int) -> torch.Tensor:
    """uint8 values in [0, 2^bits) along the last axis -> 8//bits per byte,
    value ``j*k+i`` in bits ``[i*bits, i*bits+bits)`` of byte ``j``."""
    k = lanes_per_byte(bits)
    if k == 1:
        return q.to(torch.uint8)
    pad = (-q.shape[-1]) % k
    if pad:
        q = torch.nn.functional.pad(q, (0, pad))
    grouped = q.reshape(*q.shape[:-1], -1, k).to(torch.uint8)
    shifts = torch.arange(k, dtype=torch.uint8, device=q.device) * bits
    # the lanes occupy disjoint bits, so their sum is their bitwise or
    return (grouped << shifts).sum(dim=-1).to(torch.uint8)


def unpack_lanes(packed: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """Inverse of :func:`pack_lanes`: uint8 values of width ``d``."""
    k = lanes_per_byte(bits)
    if k == 1:
        return packed[..., :d]
    shifts = torch.arange(k, dtype=torch.uint8, device=packed.device) * bits
    vals = (packed[..., None] >> shifts) & ((1 << bits) - 1)
    return vals.reshape(*packed.shape[:-1], -1)[..., :d]


def scale_of(rng: torch.Tensor, bits: int) -> torch.Tensor:
    """Per-row scale ``rng / (2^bits - 1)`` as the JAX reference computes
    it: XLA rewrites the division by the constant into a multiply by its
    float32 reciprocal, so the scale is ``rng * f32(1 / B)`` (and ``csrc``
    does the same). Spelled out with a tensor operand, so PyTorch neither
    divides nor widens the scalar, on the CPU or on CUDA."""
    recip = float(np.float32(1.0) / np.float32(2 ** bits - 1))
    return rng * torch.full_like(rng, recip)


def quantize_pack_ref(h: torch.Tensor, u: Optional[torch.Tensor], bits: int):
    """(rows, d) float32 + (rows, d) uniform[0,1) noise -> (packed uint8,
    scale f32, zero f32). ``u=None`` rounds deterministically (half to even).

    Per-row affine quantization (paper Equ. 3) with stochastic rounding
    (Equ. 4)."""
    big = float(2 ** bits - 1)
    lo = h.amin(dim=-1, keepdim=True)
    hi = h.amax(dim=-1, keepdim=True)
    rng = hi - lo
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    hbar = (h - lo) / safe * big
    if u is None:
        q = torch.round(hbar)
    else:
        floor = torch.floor(hbar)
        q = floor + (u < (hbar - floor)).to(torch.float32)
    q = q.clamp(0.0, big).to(torch.uint8)
    return pack_lanes(q, bits), scale_of(rng[:, 0], bits), lo[:, 0]


def unpack_dequantize_ref(packed: torch.Tensor, scale: torch.Tensor,
                          zero: torch.Tensor, bits: int, d: int) -> torch.Tensor:
    """(rows, packed_width) uint8 + per-row (scale, zero) f32 -> (rows, d) f32."""
    vals = unpack_lanes(packed, bits, d).to(torch.float32)
    return vals * scale[:, None] + zero[:, None]
