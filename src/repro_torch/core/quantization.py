"""Low-bit Module: b-bit affine quantization with stochastic rounding (Sylvie §3.2).

Implements Equ. 3-5 of the paper:

    hbar = (h - min(h)) / (max(h) - min(h)) * B          with B = 2^b - 1
    q    = floor(hbar) + Bernoulli(hbar - floor(hbar))    (stochastic rounding, Equ. 4)
    h~   = q * (max - min) / B + min                      (dequantize, Equ. 5)

One (scale, zero) pair per feature vector (last axis), carried in
``scale_dtype`` (bf16 by default). Bit-widths:

  * b in {1, 2, 4}: packed 8//b values per byte into uint8;
  * b = 8: uint8, one value per byte;
  * b in {3, 5, 6, 7}: unpacked uint8 values;
  * b = 16: bf16 passthrough; b = 32: fp32 passthrough (no scale/zero).

Widths {1, 2, 4, 8} go through the fused kernels of
``repro_torch.kernels.quant`` (the CUDA kernel on a CUDA tensor, its plain
version on the CPU); 3/5/6/7 and the passthroughs are plain PyTorch. Which
runs is decided by the tensor's device alone. The kernels write and read
scale/zero in float32 or bfloat16 directly, so a bf16 exchange launches no
casts around them.

The stochastic noise is a uniform ``u`` at ``h.shape``, drawn from the
caller's ``torch.Generator`` or passed in by the caller (the parity tests pass
the JAX draw), so payloads, scales and zeros equal ``repro.core.quantization``
bit for bit given the same ``h`` and ``u``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.quant import ops as kops
from ..kernels.quant.ref import pack_lanes, scale_of, unpack_lanes

PACKABLE_BITS = (1, 2, 4)
PASSTHROUGH_BITS = (16, 32)
KERNEL_BITS = (1, 2, 4, 8)        # widths the fused kernels implement


@dataclasses.dataclass(frozen=True)
class QuantizedTensor:
    """Quantized payload + error-compensation info (scale, zero).

    ``data`` is uint8 (packed when bits in {1,2,4}) or bf16/fp32 for
    passthrough. ``scale``/``zero`` are per leading row; empty (``(..., 0)``)
    for the passthrough widths."""

    data: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    feat_dim: int

    @property
    def payload_bits_per_value(self) -> float:
        return float(self.bits)


def _lanes_per_byte(bits: int) -> int:
    return 8 // bits if bits in PACKABLE_BITS else 1


def packed_width(feat_dim: int, bits: int) -> int:
    """Width of the uint8 payload row for a feat_dim-wide vector."""
    if bits in PASSTHROUGH_BITS:
        return feat_dim  # not bytes; dtype carries width
    k = _lanes_per_byte(bits)
    return (feat_dim + k - 1) // k


def comm_bytes(n_rows: int, feat_dim: int, bits: int,
               scale_dtype: torch.dtype = torch.bfloat16) -> tuple[int, int]:
    """(main payload bytes, error-compensation bytes) for one exchange buffer."""
    if bits == 32:
        return n_rows * feat_dim * 4, 0
    if bits == 16:
        return n_rows * feat_dim * 2, 0
    payload = n_rows * packed_width(feat_dim, bits)
    ec = 2 * n_rows * scale_dtype.itemsize  # scale + zero per row
    return payload, ec


def pack_bits(vals: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack uint8 values in [0, 2^bits-1] along the last axis, 8//bits per byte."""
    if bits not in PACKABLE_BITS:
        return vals.to(torch.uint8)
    return pack_lanes(vals, bits)


def unpack_bits(packed: torch.Tensor, bits: int, feat_dim: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits`; returns uint8 values of width ``feat_dim``."""
    if bits not in PACKABLE_BITS:
        return packed[..., :feat_dim]
    return unpack_lanes(packed, bits, feat_dim)


def theoretical_variance(h: torch.Tensor, bits: int) -> torch.Tensor:
    """Theorem 1 variance of the dequantized vector: D (max-min)^2 / (6 B^2)."""
    b = 2.0 ** bits - 1.0
    rng = h.amax(dim=-1) - h.amin(dim=-1)
    return h.shape[-1] * rng ** 2 / (6.0 * b ** 2)


def _empty_ec(h: torch.Tensor) -> torch.Tensor:
    return torch.zeros(h.shape[:-1] + (0,), dtype=torch.float32,
                       device=h.device)


def quantize(h: torch.Tensor, bits: int,
             generator: Optional[torch.Generator] = None,
             stochastic: bool = True,
             scale_dtype: torch.dtype = torch.bfloat16,
             u: Optional[torch.Tensor] = None) -> QuantizedTensor:
    """Quantize ``h`` (..., D) to ``bits``-bit integers per Equ. 3-4.

    Stochastic rounding needs noise: ``u`` (uniform [0, 1) at ``h.shape``)
    or a ``generator`` to draw it from. ``stochastic=False`` rounds to the
    nearest integer, half to even."""
    d = h.shape[-1]
    if bits == 32:
        return QuantizedTensor(h.to(torch.float32), _empty_ec(h), _empty_ec(h),
                               32, d)
    if bits == 16:
        return QuantizedTensor(h.to(torch.bfloat16), _empty_ec(h),
                               _empty_ec(h), 16, d)
    h = h.to(torch.float32)
    if not stochastic:
        u = None
    elif u is None:
        if generator is None:
            raise ValueError("stochastic quantization needs a generator or "
                             "the noise u")
        u = torch.rand(h.shape, generator=generator, dtype=torch.float32,
                       device=h.device)
    elif tuple(u.shape) != tuple(h.shape):
        raise ValueError(f"noise u must have h's shape {tuple(h.shape)}, got "
                         f"{tuple(u.shape)}")
    lead = h.shape[:-1]
    if bits in KERNEL_BITS:
        # the kernel writes the wire's scale dtype itself where it can
        kdt = scale_dtype if scale_dtype in kops.SCALE_DTYPES else \
            torch.float32
        packed, scale, zero = kops.quantize_pack_rows(
            h.reshape(-1, d).contiguous(),
            None if u is None else u.to(torch.float32).reshape(-1, d)
            .contiguous(), bits, kdt)
        return QuantizedTensor(packed.reshape(lead + (packed.shape[-1],)),
                               scale.reshape(lead).to(scale_dtype),
                               zero.reshape(lead).to(scale_dtype), bits, d)

    big = 2.0 ** bits - 1.0
    lo = h.amin(dim=-1, keepdim=True)
    hi = h.amax(dim=-1, keepdim=True)
    rng = hi - lo
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    hbar = (h - lo) / safe * big                       # in [0, B]
    if u is not None:
        floor = torch.floor(hbar)
        q = floor + (u < (hbar - floor)).to(torch.float32)   # Equ. 4
    else:
        q = torch.round(hbar)
    q = q.clamp(0.0, big).to(torch.uint8)
    return QuantizedTensor(pack_bits(q, bits),
                           scale_of(rng, bits).to(scale_dtype)[..., 0],
                           lo.to(scale_dtype)[..., 0], bits, d)


def dequantize(qt: QuantizedTensor,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Recover full-precision values per Equ. 5 (unbiased given Equ. 4)."""
    if qt.bits in PASSTHROUGH_BITS:
        return qt.data.to(out_dtype)
    if qt.bits in KERNEL_BITS:
        w = qt.data.shape[-1]
        lead = qt.data.shape[:-1]
        kdt = qt.scale.dtype if qt.scale.dtype in kops.SCALE_DTYPES else \
            torch.float32
        out = kops.dequantize_rows(
            qt.data.reshape(-1, w).contiguous(),
            qt.scale.reshape(-1).to(kdt).contiguous(),
            qt.zero.reshape(-1).to(kdt).contiguous(),
            qt.bits, qt.feat_dim)
        return out.reshape(lead + (qt.feat_dim,)).to(out_dtype)
    vals = unpack_bits(qt.data, qt.bits, qt.feat_dim).to(torch.float32)
    out = vals * qt.scale[..., None].to(torch.float32) \
        + qt.zero[..., None].to(torch.float32)
    return out.to(out_dtype)


def fake_quantize(h: torch.Tensor, bits: int,
                  generator: Optional[torch.Generator] = None,
                  stochastic: bool = True,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dequantize(quantize(h)) in one call — the simulated-communication
    value, in ``h``'s dtype."""
    return dequantize(quantize(h, bits, generator, stochastic, u=u), h.dtype)


class _StraightThrough(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, bits, generator, stochastic, u):
        return fake_quantize(h, bits, generator, stochastic, u)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


def straight_through_quantize(h: torch.Tensor, bits: int,
                              generator: Optional[torch.Generator] = None,
                              stochastic: bool = True,
                              u: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """:func:`fake_quantize` forward, the identity backward: the computation
    treats quantize/dequantize as the identity in the backward pass (Sylvie
    quantizes the backward *communication* separately, Alg. 2 lines
    10-12)."""
    return _StraightThrough.apply(h, bits, generator, stochastic, u)
