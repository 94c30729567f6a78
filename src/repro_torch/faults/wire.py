"""Checksummed quantized exchange: corruption injection and detection, as
``repro.faults.wire``.

The sender computes an int32 byte-sum checksum over each row of the
(packed or passthrough) payload *before* any injected corruption and ships
it through the same exchange as an int32 sidecar; the receiver recomputes it
over what arrived. A mismatched row is *never dequantized into the model*:
the caller treats it exactly like a dropped row and falls back to its cached
halo (``faults/comm.py``).

Injected corruption is one XOR of bit 0 of byte 0 of the row — the smallest
wire upset, and one a byte-sum checksum detects with certainty (the sum
changes by exactly ±1). Byte views are ``tensor.view(torch.uint8)`` of a
contiguous payload: uint8, bf16 and f32 payloads take one path, and byte 0 of
a row is the low byte of its first element on the CPU and on the card alike
(both little-endian, as the reference's ``bitcast_convert_type``).
"""
from __future__ import annotations

import torch

from ..core.exchange import PlanArrays, exchange_halo, exchange_quantized_halo
from ..core.quantization import QuantizedTensor


def _byte_view(data: torch.Tensor) -> torch.Tensor:
    """(P, rows, w) any dtype -> (P, rows, bytes) uint8 view."""
    data = data.contiguous()
    if data.dtype == torch.uint8:
        return data
    return data.view(torch.uint8)


def row_checksum(data: torch.Tensor) -> torch.Tensor:
    """(P, rows, w) payload -> (P, rows) int32 byte-sum checksum."""
    return _byte_view(data).to(torch.int32).sum(-1, dtype=torch.int32)


def flip_rows(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """XOR bit 0 of byte 0 of every row where ``mask`` (P, rows) is set."""
    bv = _byte_view(data)
    bump = torch.zeros_like(bv)
    bump[..., 0] = mask.to(torch.uint8)
    out = bv ^ bump
    return out if data.dtype == torch.uint8 else out.view(data.dtype)


def checked_exchange(qt: QuantizedTensor, plan: PlanArrays, backend,
                     corrupt_send: torch.Tensor, drop_recv: torch.Tensor,
                     reverse: bool = False
                     ) -> tuple[QuantizedTensor, torch.Tensor]:
    """Exchange ``qt`` with fault injection; -> (received qt, ok mask).

    ``corrupt_send`` (P, rows) flips payload bits on the send side;
    ``drop_recv`` (P, rows) marks rows whose message was lost (the data still
    moves — the stacked exchange is all-or-nothing — but the row is
    condemned). ``ok`` is False exactly where the receiver must fall back to
    its cache: checksum mismatch or drop. Scale/zero sidecars travel
    untouched (DESIGN.md §12)."""
    sent_sum = row_checksum(qt.data)
    qt = QuantizedTensor(data=flip_rows(qt.data, corrupt_send),
                         scale=qt.scale, zero=qt.zero, bits=qt.bits,
                         feat_dim=qt.feat_dim)
    qr = exchange_quantized_halo(qt, plan, backend, reverse=reverse)
    recv_sum = exchange_halo(sent_sum[..., None], plan, backend,
                             reverse=reverse)[..., 0]
    ok = (row_checksum(qr.data) == recv_sum) & ~drop_recv
    return qr, ok
